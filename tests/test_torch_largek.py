"""PyTorch port vs pangaea_tpu: step 1 at k = 16..31 on int64 keys.

pangaea_tpu carries a k > 15 k-mer as a split uint32 pair (hi = the
first k-16 bases, lo = the last 16) and sorts it with two keys; the port
carries the 2k-bit value ``(hi << 32) | lo`` as one int64 key. Window
values, reverse complements, canonical keys and weights must equal the
packed pairs at k = 16 (hi empty), 17, 21, 24 and 31 (sentinel 2^62); the
joins and the spill aggregation must be bit-equal to the pair kernels;
and the port's feature CSV bytes at k = 21 and 31 must equal pangaea_tpu's
(hist_impl='sortjoin') in cap and through every spill, on interleaved and
on quality-masked paired input. The CLI runs steps 1-4 at k = 21 and
refuses k outside 1..31.
"""

import gzip
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangaea_tpu.config import FeatureConfig as JaxFeatureConfig
from pangaea_tpu.features import FeatureExtractor as JaxFeatureExtractor
from pangaea_tpu.kernels import encode as jenc
from pangaea_tpu.kernels import features as jkf
from pangaea_tpu_torch.config import FeatureConfig
from pangaea_tpu_torch.features import FeatureExtractor
from pangaea_tpu_torch.io.sim import simulate_linked_reads
from pangaea_tpu_torch.kernels import encode as tenc
from pangaea_tpu_torch.kernels import features as tkf
from pangaea_tpu_torch.pipeline import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM = dict(n_species=3, genome_len=12_000, n_barcodes=200,
           pairs_per_barcode=12, read_len=90, error_rate=0.01,
           low_qual_rate=0.1, seed=31)
FEAT = dict(kmer=21, reads_per_batch=512)
CAP = 1 << 17   # ~3 aggregation chunks and ~3 key ranges at this input


def _gz(path):
    with gzip.open(path) as f:
        return f.read()


def _packed(hi, lo):
    """pangaea_tpu's (hi, lo) uint32 words as the port's int64 value."""
    return ((np.asarray(hi).astype(np.int64) << 32)
            | np.asarray(lo).astype(np.int64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- keys ----------------------------------------------------------------

def _batch(seed, R=48, L=64):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 4, (R, L)).astype(np.uint8)
    codes[rng.rand(R, L) < 0.02] = 4
    lowq = (rng.rand(R, L) < 0.04).astype(np.uint8)
    lengths = rng.randint(0, L + 1, R).astype(np.int32)
    lengths[:6] = L
    cont = (rng.rand(R) < 0.25).astype(np.uint8)
    return codes, lowq, lengths, cont


@pytest.mark.parametrize("k", [16, 17, 21, 24, 31])
def test_keys_equal_packed_split_words(k):
    codes, lowq, lengths, cont = _batch(k)
    jc, jl, jq, jt = map(jnp.asarray, (codes, lengths, lowq, cont))
    hi, lo, jvalid = jenc.kmer_window_values_pair(jc, jl, k)
    vals, valid = tenc.kmer_window_values(_t(codes), _t(lengths), k)
    assert vals.dtype == torch.int64
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    m = np.asarray(jvalid)
    assert m.sum() > 100
    np.testing.assert_array_equal(vals.numpy()[m], _packed(hi, lo)[m])
    # reverse complement and canonical form on every valid window
    rc = tenc.revcomp_kmers(vals, k).numpy()
    np.testing.assert_array_equal(
        rc[m], _packed(*jenc.revcomp_kmers_pair(hi, lo, k))[m])
    canon = tenc.canonical_kmers(vals, k).numpy()
    np.testing.assert_array_equal(
        canon[m], _packed(*jenc.canonical_kmers_pair(hi, lo, k))[m])
    assert canon[m].max() < 4 ** k
    # the batch keys (sentinel 4^k) and the masked weights; pangaea_tpu's
    # weighted pair function gives the keys of batch_kmer_keys_pair too
    (wh, wl), ww = jkf.batch_kmer_keys_pair_weighted(jc, jq, jl, jt, k=k,
                                                     overlap=k - 1)
    want = _packed(wh, wl)
    keys = tkf.batch_kmer_keys(_t(codes), _t(lengths), _t(cont), k=k,
                               overlap=k - 1)
    np.testing.assert_array_equal(keys.numpy(), want)
    assert (want == 4 ** k).any()
    tk, tw = tkf.batch_kmer_keys_weighted(_t(codes), _t(lowq), _t(lengths),
                                          _t(cont), k=k, overlap=k - 1)
    np.testing.assert_array_equal(tk.numpy(), want)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(ww))
    assert tw.dtype == torch.int32 and 0 < int(tw.sum()) < m.sum()


def _pair_keys(seed, n=5000, k=21):
    """Heavily duplicated (hi, lo) keys, sentinels among them, and their
    0/1 weights (0 on the sentinel)."""
    rng = np.random.RandomState(seed)
    hi = rng.randint(0, 4 ** (k - 16), 90).astype(np.uint32)
    lo = rng.randint(0, 2 ** 32, 90, dtype=np.int64).astype(np.uint32)
    pick = rng.randint(0, 90, n)
    hi, lo = hi[pick], lo[pick]
    sent = rng.rand(n) < 0.1
    hi[sent], lo[sent] = jkf.kmer_key_sentinel_pair(k)
    w = (rng.rand(n) < 0.7).astype(np.int32)
    w[sent] = 0
    return hi, lo, w


@pytest.mark.parametrize("weighted", [False, True])
def test_sortjoin_bins_equal_pair(weighted):
    hi, lo, w = _pair_keys(3 + weighted)
    keys = _t(_packed(hi, lo))
    if weighted:
        want = jkf.sortjoin_bins_weighted_pair(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w), k=21,
            window=3, vector_size=20)
        got = tkf.sortjoin_bins_weighted(keys, _t(w), k=21, window=3,
                                         vector_size=20)
    else:
        want = jkf.sortjoin_bins_pair(jnp.asarray(hi), jnp.asarray(lo),
                                      k=21, window=3, vector_size=20)
        got = tkf.sortjoin_bins(keys, k=21, window=3, vector_size=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("weighted", [False, True])
def test_spill_aggregate_equal_pair(weighted):
    hi, lo, w = _pair_keys(7 + weighted, n=8000)
    keys = _t(_packed(hi, lo))
    if weighted:
        want = jkf.spill_aggregate_pair_weighted(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w), k=21)
        got = tkf.spill_aggregate_weighted(keys, _t(w), k=21)
    else:
        want = jkf.spill_aggregate_pair(jnp.asarray(hi), jnp.asarray(lo),
                                        k=21)
        got = tkf.spill_aggregate(keys, k=21)
    w_ids, (w_hi, w_lo), w_uw, w_runs, w_valid = want
    ids, uniq, uw, n_runs, n_valid = got
    assert (n_runs, n_valid) == (int(w_runs), int(w_valid))
    assert n_runs == n_valid + 1 and uniq.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), np.asarray(w_ids))
    np.testing.assert_array_equal(uniq[:n_valid].numpy(),
                                  _packed(w_hi, w_lo)[:n_valid])
    np.testing.assert_array_equal(uw[:n_valid].numpy(),
                                  np.asarray(w_uw)[:n_valid])


# ---- feature CSVs --------------------------------------------------------

@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_largek")
    fq, r1, r2 = (str(d / n) for n in ("i.fq.gz", "r1.fq.gz", "r2.fq.gz"))
    simulate_linked_reads(out_interleaved=fq, **SIM)
    simulate_linked_reads(out_r1=r1, out_r2=r2, **SIM)
    return {"interleaved": dict(interleaved=fq),
            "paired": dict(reads1=r1, reads2=r2)}


@pytest.fixture(scope="module")
def jax_bytes(reads, tmp_path_factory):
    """pangaea_tpu's k = 21 feature CSV bytes per input form (its
    split-word sort-join; paired input quality-masked)."""
    d = tmp_path_factory.mktemp("jax_largek")
    out = {}
    for form, inp in reads.items():
        fe = JaxFeatureExtractor(JaxFeatureConfig(hist_impl="sortjoin",
                                                  **FEAT), str(d / form))
        fe.extract_features(**inp)
        out[form] = (_gz(fe.abd_gz), _gz(fe.tnf_gz))
    return out


def _port(tmp_path, tag, inp, **cfg):
    fe = FeatureExtractor(FeatureConfig(**{**FEAT, **cfg}),
                          str(tmp_path / tag), device="cpu")
    fe.extract_features(**inp)
    return fe, (_gz(fe.abd_gz), _gz(fe.tnf_gz))


@pytest.mark.parametrize("form", ["interleaved", "paired"])
def test_k21_csv_bytes_equal_jax(reads, jax_bytes, tmp_path, form):
    fe, got = _port(tmp_path, form, reads[form])
    assert fe.stats["spill"] == "none"
    assert got == jax_bytes[form]


@pytest.mark.parametrize("form,spill,store", [
    ("interleaved", "agg", "device"),
    ("interleaved", "agg", "host"),
    ("interleaved", "agg", "disk"),
    ("interleaved", "raw", "host"),
    ("paired", "agg", "disk"),
    ("paired", "raw", "host"),
])
def test_k21_spill_csv_bytes_equal_jax(reads, jax_bytes, tmp_path, form,
                                       spill, store):
    """Every spill at k = 21: the aggregated spill's int64 unique runs in
    each store (the disk store's rows carry both key words), and the raw
    spill's ranged join on int64 keys."""
    spill_dir = str(tmp_path / "spill") if store == "disk" else None
    cfg = (dict(spill_agg="off") if spill == "raw" else
           dict(spill_store=store, spill_dir=spill_dir))
    fe, got = _port(tmp_path, f"{form}-{spill}-{store}", reads[form],
                    sortjoin_max_windows=CAP, **cfg)
    assert (fe.stats["spill"], fe.stats["store"]) == (spill, store)
    assert fe.stats["spill_chunks"] > 2 or fe.stats["ranges"] > 2
    assert got == jax_bytes[form]
    if spill_dir:
        assert os.listdir(spill_dir) == []


def test_k31_csv_bytes_equal_jax(reads, tmp_path):
    """k = 31: the largest key (sentinel 2^62)."""
    inp = reads["interleaved"]
    jfe = JaxFeatureExtractor(JaxFeatureConfig(
        hist_impl="sortjoin", **{**FEAT, "kmer": 31}), str(tmp_path / "j"))
    jfe.extract_features(**inp)
    fe, got = _port(tmp_path, "p", inp, kmer=31)
    assert got == (_gz(jfe.abd_gz), _gz(jfe.tnf_gz))
    assert os.path.basename(fe.abd_gz) == "abundance.k31.v400.w10.m2000.gz"


# ---- entry points ----------------------------------------------------------

def test_k_outside_1_to_31_is_refused(reads, tmp_path):
    for k in (0, 32):
        fe = FeatureExtractor(FeatureConfig(kmer=k), str(tmp_path / str(k)),
                              device="cpu")
        with pytest.raises(ValueError, match="1..31"):
            fe.extract_features(**reads["interleaved"])
        assert not os.path.exists(fe.marker)
        with pytest.raises(SystemExit) as e:
            cli.main(["-i", "x.fq", "-o", str(tmp_path / "o"), "-c", "4",
                      "-k", str(k)])
        assert e.value.code == 2


def test_cli_k21_runs_steps_1_to_4(tmp_path):
    """``python -m pangaea_tpu_torch.pipeline.cli -k 21`` runs the default
    steps 1,2,3,4 on a small clean sim."""
    fq = str(tmp_path / "reads.fq.gz")
    simulate_linked_reads(out_interleaved=fq, n_species=2, genome_len=8_000,
                          n_barcodes=40, pairs_per_barcode=25, seed=5)
    out = str(tmp_path / "out")
    r = subprocess.run(
        [sys.executable, "-m", "pangaea_tpu_torch.pipeline.cli", "-i", fq,
         "-o", out, "-k", "21", "-c", "2", "-e", "2", "-b", "64", "-l", "500",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for sub, marker in (("1.features", "feature_finished"),
                        ("2.vae", "model_finished"),
                        ("3.clustering", "clustering_finished"),
                        ("4.assembly", "assemble_finished")):
        assert os.path.exists(os.path.join(out, sub, marker)), sub
    assert os.path.exists(os.path.join(out, "1.features",
                                       "abundance.k21.v400.w10.m500.gz"))
    assert os.path.getsize(os.path.join(out, "final_asm.fa")) > 0
