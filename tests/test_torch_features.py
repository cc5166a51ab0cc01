"""PyTorch port vs pangaea_tpu: sort-join bins, histograms, feature CSVs.

Integer outputs must be bit-equal: per-window bins (exact order, and the
per-row multiset of the row-grouped JAX kernel), both per-group
histograms (with dropped seg -1 rows present), and the decompressed bytes
of the step-1 feature CSVs of the port's FeatureExtractor(device="cpu")
against pangaea_tpu's FeatureExtractor(hist_impl='sortjoin') on simulated
reads — clean, error-injected, and a stream of several batches and
chunks.
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangaea_tpu.config import FeatureConfig as JaxFeatureConfig
from pangaea_tpu.features import FeatureExtractor as JaxFeatureExtractor
from pangaea_tpu.io.sim import simulate_linked_reads as jax_simulate
from pangaea_tpu.kernels import features as jkf
from pangaea_tpu_torch.config import FeatureConfig
from pangaea_tpu_torch.features import FeatureExtractor
from pangaea_tpu_torch.io.sim import simulate_linked_reads
from pangaea_tpu_torch.kernels import features as tkf

SIM = dict(n_species=4, genome_len=30_000, n_barcodes=150,
           pairs_per_barcode=30, seed=11)


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_feat")
    out = {}
    for name, extra in (("errors", dict(error_rate=0.005,
                                        low_qual_rate=0.15)),
                        ("clean", {})):
        path = str(d / f"{name}.fq.gz")
        simulate_linked_reads(out_interleaved=path, **SIM, **extra)
        out[name] = path
    return out


def _gz(path):
    with gzip.open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_features(sims, tmp_path_factory):
    """pangaea_tpu's feature CSV bytes on each sim (sort-join forced)."""
    d = tmp_path_factory.mktemp("jax_feat")
    out = {}
    for name, path in sims.items():
        fe = JaxFeatureExtractor(JaxFeatureConfig(hist_impl="sortjoin"),
                                 str(d / name))
        fe.extract_features(interleaved=path)
        out[name] = (_gz(fe.abd_gz), _gz(fe.tnf_gz))
    return out


def test_simulator_copy_writes_same_bytes(tmp_path):
    a, b = str(tmp_path / "a.fq.gz"), str(tmp_path / "b.fq.gz")
    kw = dict(SIM, n_barcodes=20, error_rate=0.01, low_qual_rate=0.1)
    ra = simulate_linked_reads(out_interleaved=a, **kw)
    rb = jax_simulate(out_interleaved=b, **kw)
    assert _gz(a) == _gz(b)
    assert ra.barcode_species == rb.barcode_species


def _keys(seed, n_rows=64, row_windows=7, k=4):
    rng = np.random.RandomState(seed)
    n = n_rows * row_windows
    keys = rng.randint(0, 60, n).astype(np.int32)   # heavy duplication
    keys[rng.rand(n) < 0.1] = jkf.kmer_key_sentinel(k)
    pad = jkf.sortjoin_pad_size(n) - n
    return np.concatenate([keys, np.full(pad, 4 ** k, np.int32)]), n


@pytest.mark.parametrize("seed", [0, 1])
def test_sortjoin_bins_exact_order(seed):
    keys, _ = _keys(seed)
    want = np.asarray(jkf.sortjoin_bins(jnp.asarray(keys), k=4, window=2,
                                        vector_size=12))
    got = tkf.sortjoin_bins(torch.from_numpy(keys), k=4, window=2,
                            vector_size=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sortjoin_bins_rowgrouped_multiset():
    keys, n = _keys(2)
    rw = 7
    want = np.asarray(jkf.sortjoin_bins_rowgrouped(
        jnp.asarray(keys), k=4, window=2, vector_size=12, row_windows=rw))
    got = tkf.sortjoin_bins(torch.from_numpy(keys), k=4, window=2,
                            vector_size=12).numpy()
    for r in range(n // rw):
        np.testing.assert_array_equal(np.sort(got[r * rw:(r + 1) * rw]),
                                      np.sort(want[r * rw:(r + 1) * rw]))


def test_sortjoin_pad_size_equal():
    for n in (1, 2, 3, 1000, 1 << 20, (1 << 20) + 1, 37_000_001):
        assert tkf.sortjoin_pad_size(n) == jkf.sortjoin_pad_size(n)


def _segs(rng, R, G):
    seg = np.sort(rng.randint(0, G, R)).astype(np.int32)
    seg[rng.rand(R) < 0.2] = -1      # dropped groups / padding rows
    seg[-5:] = -1
    return seg


def test_abundance_histogram_from_bins_bit_equal():
    rng = np.random.RandomState(3)
    R, W, V, G = 96, 20, 30, 16
    bins = rng.randint(-1, V, (R, W)).astype(np.int32)
    seg = _segs(rng, R, G)
    hist0 = rng.randint(0, 5, (G, V)).astype(np.int32)
    want = np.asarray(jkf.abundance_histogram_from_bins(
        jnp.asarray(hist0), jnp.asarray(bins), jnp.asarray(seg),
        vector_size=V, n_groups=G))
    got = tkf.abundance_histogram_from_bins(
        torch.from_numpy(hist0.copy()), torch.from_numpy(bins),
        torch.from_numpy(seg), vector_size=V)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tnf_k", [3, 4])
def test_tnf_histogram_bit_equal(tnf_k):
    rng = np.random.RandomState(tnf_k)
    R, L, G = 80, 40, 12
    codes = rng.randint(0, 4, (R, L)).astype(np.uint8)
    codes[rng.rand(R, L) < 0.03] = 4
    lengths = rng.randint(0, L + 1, R).astype(np.int32)
    cont = (rng.rand(R) < 0.25).astype(np.uint8)
    seg = _segs(rng, R, G)
    ncols = tkf.canonical_rank_lut(tnf_k).max() + 1
    want = np.asarray(jkf.tnf_histogram_segsum(
        jnp.zeros((G, ncols), jnp.int32), jnp.asarray(codes),
        jnp.asarray(lengths), jnp.asarray(seg), jnp.asarray(cont), k=tnf_k,
        num_cols=int(ncols), overlap=14, n_groups=G))
    got = tkf.tnf_histogram_segsum(
        torch.zeros((G, ncols), dtype=torch.int32), torch.from_numpy(codes),
        torch.from_numpy(lengths), torch.from_numpy(seg),
        torch.from_numpy(cont), k=tnf_k, overlap=14,
        rank_lut=tkf.rank_lut_tensor(tnf_k, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["errors", "clean"])
def test_feature_csv_bytes_equal_jax(name, sims, jax_features, tmp_path):
    fe = FeatureExtractor(FeatureConfig(), str(tmp_path), device="cpu")
    names, abd, tnf = fe.extract_features(interleaved=sims[name])
    assert abd.shape == (SIM["n_barcodes"], 400) and tnf.shape[1] == 136
    assert (_gz(fe.abd_gz), _gz(fe.tnf_gz)) == jax_features[name]
    assert os.path.exists(fe.marker)
    # resume: a second extraction loads the artifacts
    n2, a2, t2 = FeatureExtractor(FeatureConfig(), str(tmp_path),
                                  device="cpu").extract_features(
        interleaved=sims[name])
    assert list(n2) == list(names)
    np.testing.assert_array_equal(a2, abd)
    np.testing.assert_array_equal(t2, tnf)


def test_feature_csv_bytes_equal_multi_chunk(sims, jax_features, tmp_path):
    """Several batches per chunk and several chunks per stream, with
    trimmed tail batches, must give the same bytes."""
    fe = FeatureExtractor(FeatureConfig(reads_per_batch=512),
                          str(tmp_path), device="cpu")
    fe.groups_per_chunk = 16
    fe.extract_features(interleaved=sims["errors"], defer_save=True)
    fe.wait_save()
    assert 1 < fe.stats["chunks"] < fe.stats["batches"]
    assert (_gz(fe.abd_gz), _gz(fe.tnf_gz)) == jax_features["errors"]


def test_write_csv_gz_uses_unique_temp(tmp_path):
    """pangaea_tpu writes through the fixed name path + '.tmp'; the port's
    temp name is unique, so a stale or concurrent '.tmp' cannot clash,
    and a failed write leaves neither a partial file nor a temp file."""
    path = str(tmp_path / "x.gz")
    os.mkdir(path + ".tmp")   # the fixed temp name is taken
    FeatureExtractor._write_csv_gz(path, np.array(["a", "b,c"]),
                                   np.array([[1, 2], [3, -4]]))
    assert _gz(path) == b'a,1,2\n"b,c",3,-4\n'
    names, mat = FeatureExtractor._read_csv_gz(path)
    assert list(names) == ["a", "b,c"]
    np.testing.assert_array_equal(mat, [[1, 2], [3, -4]])

    bad = str(tmp_path / "y.gz")
    with pytest.raises(TypeError):
        FeatureExtractor._write_csv_gz(bad, np.array(["a"]), object())
    assert not os.path.exists(bad)
    assert sorted(os.listdir(tmp_path)) == ["x.gz", "x.gz.tmp"]


def test_csv_writer_matches_pandas_bytes(tmp_path):
    """The csv-module writer gives pangaea_tpu's pandas bytes, quoting
    included."""
    names = np.array(["ACGT", "with,comma", 'quo"te', "NA", "007"])
    mat = np.random.RandomState(0).randint(-5, 10 ** 6, (5, 7))
    path = str(tmp_path / "p.gz")
    FeatureExtractor._write_csv_gz(path, names, mat)
    JaxFeatureExtractor._write_csv_gz(str(tmp_path / "j.gz"), names, mat)
    assert _gz(path) == _gz(str(tmp_path / "j.gz"))
    got_names, got = FeatureExtractor._read_csv_gz(path)
    assert list(got_names) == list(names)
    np.testing.assert_array_equal(got, mat)


def test_unported_inputs_raise(sims, tmp_path):
    """What pangaea_tpu cannot run either raises ValueError and writes
    nothing: k outside 1..31, and a dense-table path (scatter or segsum)
    at k > 15 (pangaea_tpu/features.py:1581-1590). k = 16..31 and the
    table paths at k <= 15 run: tests/test_torch_largek.py and
    tests/test_torch_table.py."""
    cases = {"a": (dict(kmer=32), "1..31"),
             "b": (dict(kmer=16, hist_impl="scatter"), "sort-join"),
             "c": (dict(kmer=21, hist_impl="segsum"), "sort-join"),
             "d": (dict(hist_impl="bogus"), "hist_impl")}
    for tag, (cfg, match) in cases.items():
        fe = FeatureExtractor(FeatureConfig(**cfg), str(tmp_path / tag),
                              device="cpu")
        with pytest.raises(ValueError, match=match):
            fe.extract_features(reads1=sims["clean"], reads2=sims["clean"])
        assert not os.listdir(str(tmp_path / tag))
