"""PyTorch port vs pangaea_tpu: the dense-table paths and jellyfish dumps.

``hist_impl='scatter'`` and ``'segsum'`` count every read into a 4^k
table (the global pass through the native reader, quality-masked on
paired input) and look each window's count up in the group pass. The
table kernels must be bit-equal to pangaea_tpu's (its 'segsum' twins
included), the global-pass batches equal, the feature CSV bytes of both
names equal to pangaea_tpu's on interleaved and paired input, and a
jellyfish export -> import round trip must give pangaea_tpu's dump bytes
and table. k <= 11 keeps the table small on the CPU.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangaea_tpu.config import FeatureConfig as JaxFeatureConfig
from pangaea_tpu.features import FeatureExtractor as JaxFeatureExtractor
from pangaea_tpu.io.fast_packing import native_seq_batches as jax_batches
from pangaea_tpu.kernels import encode as jenc
from pangaea_tpu.kernels import features as jkf
from pangaea_tpu_torch.config import FeatureConfig
from pangaea_tpu_torch.features import FeatureExtractor
from pangaea_tpu_torch.io.fast_packing import native_seq_batches
from pangaea_tpu_torch.io.sim import simulate_linked_reads
from pangaea_tpu_torch.kernels import encode as tenc
from pangaea_tpu_torch.kernels import features as tkf

SIM = dict(n_species=3, genome_len=12_000, n_barcodes=120,
           pairs_per_barcode=12, read_len=90, error_rate=0.01,
           low_qual_rate=0.1, seed=37)
FEAT = dict(kmer=11, reads_per_batch=512)


def _gz(path):
    with gzip.open(path) as f:
        return f.read()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(seed, R=80, L=48):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 4, (R, L)).astype(np.uint8)
    codes[rng.rand(R, L) < 0.03] = 4
    lengths = rng.randint(0, L + 1, R).astype(np.int32)
    cont = (rng.rand(R) < 0.25).astype(np.uint8)
    seg = np.sort(rng.randint(0, 10, R)).astype(np.int32)
    seg[rng.rand(R) < 0.2] = -1
    return codes, lengths, seg, cont


# ---- kernels -------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 11])
def test_count_kmers_global_bit_equal(k):
    want = jkf.make_global_table(k)
    got = tkf.make_global_table(k, "cpu")
    for seed in range(3):   # accumulates over batches
        codes, lengths, _, cont = _batch(10 * k + seed)
        want = jkf.count_kmers_global(want, jnp.asarray(codes),
                                      jnp.asarray(lengths),
                                      jnp.asarray(cont), k=k, overlap=k - 1)
        tkf.count_kmers_global(got, _t(codes), _t(lengths), _t(cont), k=k,
                               overlap=k - 1)
    assert got.dtype == torch.int32 and int(got.sum()) > 1000
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_global_table_refuses_k_over_15():
    with pytest.raises(ValueError, match="k <= 15"):
        tkf.make_global_table(16, "cpu")


@pytest.mark.parametrize("impl", ["scatter", "segsum"])
def test_abundance_histogram_bit_equal(impl):
    """Against both of pangaea_tpu's formulations: the flat scatter and
    the scatter-free compare-expand / row-gather / segment sum."""
    k, V, W, G = 5, 30, 2, 10
    table = tkf.make_global_table(k, "cpu")
    for seed in range(2):
        codes, lengths, _, cont = _batch(seed)
        tkf.count_kmers_global(table, _t(codes), _t(lengths), _t(cont), k=k,
                               overlap=14)
    codes, lengths, seg, cont = _batch(7)
    args = tuple(map(jnp.asarray, (codes, lengths, seg, cont)))
    jt = jnp.asarray(table.numpy())
    if impl == "scatter":
        want = np.asarray(jkf.abundance_histogram(
            jnp.zeros(G * V, jnp.int32), jt, *args, k=k, window=W,
            vector_size=V, overlap=14)).reshape(G, V)
    else:
        want = np.asarray(jkf.abundance_histogram_segsum(
            jnp.zeros((G, V), jnp.int32), jt, *args, k=k, window=W,
            vector_size=V, overlap=14, n_groups=G))
    got = tkf.abundance_histogram(torch.zeros((G, V), dtype=torch.int32),
                                  table, _t(codes), _t(lengths), _t(seg),
                                  _t(cont), k=k, window=W, vector_size=V,
                                  overlap=14)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum()


@pytest.mark.parametrize("tnf_k", [3, 4])
def test_tnf_histogram_bit_equal(tnf_k):
    """The port's one TNF scatter-add against pangaea_tpu's table-path
    ``tnf_histogram`` (its sort-join twin: tests/test_torch_features.py)."""
    codes, lengths, seg, cont = _batch(tnf_k)
    G = 10
    ncols = tenc.num_canonical_kmers(tnf_k)
    want = np.asarray(jkf.tnf_histogram(
        jnp.zeros(G * ncols, jnp.int32),
        jnp.asarray(jenc.canonical_rank_lut(tnf_k)),
        *map(jnp.asarray, (codes, lengths, seg, cont)), k=tnf_k,
        num_cols=ncols, overlap=14)).reshape(G, ncols)
    got = tkf.tnf_histogram_segsum(
        torch.zeros((G, ncols), dtype=torch.int32), _t(codes), _t(lengths),
        _t(seg), _t(cont), k=tnf_k, overlap=14,
        rank_lut=tkf.rank_lut_tensor(tnf_k, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the global pass and the feature CSVs ----------------------------------

@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_table")
    fq, r1, r2 = (str(d / n) for n in ("i.fq.gz", "r1.fq.gz", "r2.fq.gz"))
    simulate_linked_reads(out_interleaved=fq, **SIM)
    simulate_linked_reads(out_r1=r1, out_r2=r2, **SIM)
    return {"interleaved": dict(interleaved=fq),
            "paired": dict(reads1=r1, reads2=r2)}


@pytest.mark.parametrize("mq", [None, "?"])
def test_native_seq_batches_equal_jax(reads, mq):
    paths = [reads["paired"]["reads1"], reads["paired"]["reads2"]]
    want = list(jax_batches(paths, 96, 700, min_qual_char=mq))
    got = list(native_seq_batches(paths, 96, 700, min_qual_char=mq))
    assert len(got) == len(want) == 6   # 1,440 reads in each file
    for g, w in zip(got, want):
        for f in ("codes", "lengths", "seg_ids", "cont"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    masked = sum(int((b.codes == 4).sum()) for b in got)
    raw = sum(int((b.codes == 4).sum()) for b in native_seq_batches(
        paths, 96, 700))
    assert (masked > raw) == (mq is not None)


@pytest.fixture(scope="module")
def jax_table_bytes(reads, tmp_path_factory):
    """pangaea_tpu's CSV bytes on its scatter table path, per form."""
    d = tmp_path_factory.mktemp("jax_table")
    out = {}
    for form, inp in reads.items():
        fe = JaxFeatureExtractor(JaxFeatureConfig(hist_impl="scatter",
                                                  **FEAT), str(d / form))
        fe.extract_features(**inp)
        out[form] = (_gz(fe.abd_gz), _gz(fe.tnf_gz))
    return out


@pytest.mark.parametrize("form", ["interleaved", "paired"])
@pytest.mark.parametrize("impl", ["scatter", "segsum"])
def test_table_csv_bytes_equal_jax(reads, jax_table_bytes, tmp_path, impl,
                                   form):
    fe = FeatureExtractor(FeatureConfig(hist_impl=impl, **FEAT),
                          str(tmp_path), device="cpu")
    fe.groups_per_chunk = 32   # several chunks
    fe.extract_features(**reads[form])
    assert fe.stats["path"] == "table"
    assert (_gz(fe.abd_gz), _gz(fe.tnf_gz)) == jax_table_bytes[form]
    # pangaea_tpu's segsum formulation writes the same bytes
    if impl == "segsum" and form == "interleaved":
        jfe = JaxFeatureExtractor(JaxFeatureConfig(hist_impl="segsum",
                                                   **FEAT),
                                  str(tmp_path / "jax"))
        jfe.extract_features(**reads[form])
        assert (_gz(jfe.abd_gz), _gz(jfe.tnf_gz)) == jax_table_bytes[form]


def test_table_path_equals_sortjoin(reads, jax_table_bytes, tmp_path):
    fe = FeatureExtractor(FeatureConfig(**FEAT), str(tmp_path), device="cpu")
    fe.extract_features(**reads["paired"])
    assert fe.stats["spill"] == "none"
    assert (_gz(fe.abd_gz), _gz(fe.tnf_gz)) == jax_table_bytes["paired"]


def test_table_path_refuses_k_over_15(reads, tmp_path):
    """pangaea_tpu/features.py:1581-1590: a table path at k > 15."""
    for impl in ("scatter", "segsum"):
        fe = FeatureExtractor(FeatureConfig(kmer=16, hist_impl=impl),
                              str(tmp_path / impl), device="cpu")
        with pytest.raises(ValueError, match="sort-join"):
            fe.extract_features(**reads["interleaved"])


# ---- jellyfish dumps -------------------------------------------------------

def test_jellyfish_round_trip_equals_jax(reads, tmp_path):
    """The port's table exports the bytes pangaea_tpu exports from its
    own table; importing that dump gives pangaea_tpu's table; binning
    against it gives the self-counted features."""
    inp = reads["paired"]
    cfg = FeatureConfig(hist_impl="scatter", **FEAT)
    fe = FeatureExtractor(cfg, str(tmp_path / "p"), device="cpu")
    table = fe.global_kmer_table(**inp)
    jfe = JaxFeatureExtractor(JaxFeatureConfig(hist_impl="scatter", **FEAT),
                              str(tmp_path / "j"))
    jtable = jfe.global_kmer_table(**inp)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    n = fe.export_jellyfish_dump(table, str(tmp_path / "port.tsv"))
    jfe.export_jellyfish_dump(jtable, str(tmp_path / "jax.tsv"))
    with open(tmp_path / "port.tsv", "rb") as a, \
            open(tmp_path / "jax.tsv", "rb") as b:
        dump = a.read()
        assert dump == b.read()
    assert n == dump.count(b"\n") == int((table > 0).sum())
    # import (plain and gzipped) equals pangaea_tpu's import
    with gzip.open(tmp_path / "port.tsv.gz", "wb") as f:
        f.write(dump)
    want = np.asarray(jfe.import_jellyfish_dump(str(tmp_path / "jax.tsv")))
    for name in ("port.tsv", "port.tsv.gz"):
        back = fe.import_jellyfish_dump(str(tmp_path / name))
        np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_array_equal(want, table.numpy())
    names, abd, tnf = fe.group_features(back, **inp)
    fe2 = FeatureExtractor(cfg, str(tmp_path / "self"), device="cpu")
    n2, a2, t2 = fe2.extract_features(**inp)
    assert names.tolist() == n2.tolist()
    np.testing.assert_array_equal(abd, a2)
    np.testing.assert_array_equal(tnf, t2)


def test_jellyfish_import_recanonicalizes_like_jax(tmp_path):
    """Either strand form loads to the canonical entry, duplicates add,
    lower case reads, and a wrong length raises as in pangaea_tpu."""
    k = 5
    rng = np.random.RandomState(0)
    vals = rng.choice(4 ** k, 60, replace=False).astype(np.uint32)
    vals[:10] = tenc.revcomp_kmers_np(vals[10:20], k)   # both strands
    strs = tenc.decode_kmers(vals, k)
    np.testing.assert_array_equal(strs, jenc.decode_kmers(vals, k))
    path = str(tmp_path / "d.tsv")
    with open(path, "w") as f:
        for i, (s, c) in enumerate(zip(strs, rng.randint(1, 9, 60))):
            s = s.decode()
            f.write(f"{s.lower() if i % 3 == 0 else s}\t{c}\n")
    fe = FeatureExtractor(FeatureConfig(kmer=k), str(tmp_path / "p"),
                          device="cpu")
    jfe = JaxFeatureExtractor(JaxFeatureConfig(kmer=k), str(tmp_path / "j"))
    got = fe.import_jellyfish_dump(path)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfe.import_jellyfish_dump(path)))
    assert int(got.sum()) > 0
    with open(path, "a") as f:
        f.write("ACGTAC\t3\n")
    with pytest.raises(ValueError, match="length 6 != k=5"):
        fe.import_jellyfish_dump(path)
