"""PyTorch port vs pangaea_tpu: paired (-1/-2) input and the
quality-masked weighted sort-join.

The weighted kernels must be bit-equal to pangaea_tpu's; the port's
feature CSV bytes on paired input (masked and unmasked, native and
Python streams, mismatched R1/R2 pairs, interleaved plus paired input)
must equal pangaea_tpu's (hist_impl='sortjoin'); and the port's paired
steps 1-3 must bin as well as pangaea_tpu's (ARI > 0.95, cross-ARI >=
0.95).
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangaea_tpu.config import ClusterConfig as JaxClusterConfig
from pangaea_tpu.config import FeatureConfig as JaxFeatureConfig
from pangaea_tpu.config import ModelConfig as JaxModelConfig
from pangaea_tpu.config import PangaeaConfig as JaxPangaeaConfig
from pangaea_tpu.features import FeatureExtractor as JaxFeatureExtractor
from pangaea_tpu.kernels import features as jkf
from pangaea_tpu.pipeline import Pipeline as JaxPipeline
from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
from pangaea_tpu_torch.config import (ClusterConfig, FeatureConfig,
                                      ModelConfig, PangaeaConfig)
from pangaea_tpu_torch.features import FeatureExtractor
from pangaea_tpu_torch.io.sim import simulate_linked_reads
from pangaea_tpu_torch.kernels import features as tkf
from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished

SIM = dict(n_species=3, genome_len=12_000, n_barcodes=200,
           pairs_per_barcode=12, read_len=90, error_rate=0.01,
           low_qual_rate=0.1, seed=23)
FEAT = dict(reads_per_batch=512)


def _gz(path):
    with gzip.open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_masked")
    fq, r1, r2 = (str(d / n) for n in ("i.fq.gz", "r1.fq.gz", "r2.fq.gz"))
    simulate_linked_reads(out_interleaved=fq, **SIM)
    simulate_linked_reads(out_r1=r1, out_r2=r2, **SIM)
    # a copy of reads2 where every 7th record's name disagrees with R1
    # and every 11th record's barcode does
    bad = str(d / "r2_mismatched.fq.gz")
    with gzip.open(r2, "rt") as f:
        lines = f.read().split("\n")
    for i in range(0, len(lines) - 1, 4):
        rec = i // 4
        if rec % 7 == 3:
            lines[i] = lines[i].replace("\t", "x\t", 1)
        elif rec % 11 == 5:
            lines[i] = lines[i].replace("BX:Z:", "BX:Z:T", 1)
    with gzip.open(bad, "wt") as f:
        f.write("\n".join(lines))
    return {"interleaved": fq, "r1": r1, "r2": r2, "r2_bad": bad}


def _jax_bytes(tmp_path, mq="?", io="native", **inp):
    fe = JaxFeatureExtractor(JaxFeatureConfig(
        hist_impl="sortjoin", min_qual_char=mq,
        bug_compat_boundary_leak=io == "native", **FEAT),
        str(tmp_path / f"jax_{io}"))
    fe.extract_features(**inp)
    return _gz(fe.abd_gz), _gz(fe.tnf_gz)


def _port(tmp_path, tag, io="native", mq="?", **inp):
    """Both packages stream through their native reader under
    bug_compat_boundary_leak (the default) and through their Python
    packer without it."""
    fe = FeatureExtractor(FeatureConfig(
        min_qual_char=mq, bug_compat_boundary_leak=io == "native", **FEAT),
        str(tmp_path / tag), device="cpu")
    fe.groups_per_chunk = 32
    fe.extract_features(**inp)
    return fe, (_gz(fe.abd_gz), _gz(fe.tnf_gz))


# ---- kernels -------------------------------------------------------------

def _batch(seed, R=48, L=40):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 4, (R, L)).astype(np.uint8)
    codes[rng.rand(R, L) < 0.02] = 4
    lowq = (rng.rand(R, L) < 0.05).astype(np.uint8)
    lengths = rng.randint(0, L + 1, R).astype(np.int32)
    cont = (rng.rand(R) < 0.2).astype(np.uint8)
    return codes, lowq, lengths, cont


@pytest.mark.parametrize("k", [5, 15])
def test_batch_kmer_keys_weighted_bit_equal(k):
    codes, lowq, lengths, cont = _batch(k)
    wk, ww = jkf.batch_kmer_keys_weighted(
        jnp.asarray(codes), jnp.asarray(lowq), jnp.asarray(lengths),
        jnp.asarray(cont), k=k, overlap=14)
    tk, tw = tkf.batch_kmer_keys_weighted(
        torch.from_numpy(codes), torch.from_numpy(lowq),
        torch.from_numpy(lengths), torch.from_numpy(cont), k=k, overlap=14)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(ww))
    assert 0 < int(tw.sum()) < int((tk < 4 ** k).sum())


def _weighted_keys(seed, n=3000, k=4):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 80, n).astype(np.int32)
    keys[rng.rand(n) < 0.1] = 4 ** k
    w = (rng.rand(n) < 0.7).astype(np.int32)
    w[keys == 4 ** k] = 0
    pad = jkf.sortjoin_pad_size(n) - n
    return (np.concatenate([keys, np.full(pad, 4 ** k, np.int32)]),
            np.concatenate([w, np.zeros(pad, np.int32)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sortjoin_bins_weighted_bit_equal(seed):
    keys, w = _weighted_keys(seed)
    want = np.asarray(jkf.sortjoin_bins_weighted(
        jnp.asarray(keys), jnp.asarray(w), k=4, window=2, vector_size=20))
    got = tkf.sortjoin_bins_weighted(torch.from_numpy(keys),
                                     torch.from_numpy(w), k=4, window=2,
                                     vector_size=20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() and (want == -1).any()


def test_sortjoin_bins_weighted_rowgrouped_multiset():
    """pangaea_tpu's in-cap path restores by row; the port's exact order
    has the same multiset of bins in every row."""
    keys, w = _weighted_keys(5, n=64 * 9)
    want = np.asarray(jkf.sortjoin_bins_weighted_rowgrouped(
        jnp.asarray(keys), jnp.asarray(w), k=4, window=2, vector_size=20,
        row_windows=9))
    got = tkf.sortjoin_bins_weighted(torch.from_numpy(keys),
                                     torch.from_numpy(w), k=4, window=2,
                                     vector_size=20).numpy()
    for r in range(64):
        np.testing.assert_array_equal(np.sort(got[r * 9:(r + 1) * 9]),
                                      np.sort(want[r * 9:(r + 1) * 9]))


# ---- feature CSVs ----------------------------------------------------------

@pytest.mark.parametrize("io", ["native", "python"])
def test_masked_paired_csv_bytes_equal_jax(reads, tmp_path, io):
    want = _jax_bytes(tmp_path, io=io, reads1=reads["r1"],
                      reads2=reads["r2"])
    fe, got = _port(tmp_path, io, io=io, reads1=reads["r1"],
                    reads2=reads["r2"])
    assert fe.stats["io"] == io and fe.stats["spill"] == "none"
    assert fe.stats["chunks"] > 1
    assert got == want
    # the mask matters: unmasked counts give other bytes
    _, unmasked = _port(tmp_path, "unmasked", io=io, mq=None,
                        reads1=reads["r1"], reads2=reads["r2"])
    assert unmasked != want


def test_unmasked_paired_csv_bytes_equal_jax(reads, tmp_path):
    want = _jax_bytes(tmp_path, mq=None, reads1=reads["r1"],
                      reads2=reads["r2"])
    _, got = _port(tmp_path, "p", mq=None, reads1=reads["r1"],
                   reads2=reads["r2"])
    assert got == want


@pytest.mark.parametrize("io", ["native", "python"])
def test_mismatched_pairs_csv_bytes_equal_jax(reads, tmp_path, io):
    """Mismatched R1/R2 pairs leave the grouping but still count
    globally."""
    inp = dict(reads1=reads["r1"], reads2=reads["r2_bad"])
    want = _jax_bytes(tmp_path, io=io, **inp)
    _, got = _port(tmp_path, io, io=io, **inp)
    assert got == want
    _, clean = _port(tmp_path, "clean", io=io, reads1=reads["r1"],
                     reads2=reads["r2"])
    assert clean != want


def test_interleaved_plus_paired_prefers_interleaved(reads, tmp_path):
    want = _jax_bytes(tmp_path, interleaved=reads["interleaved"])
    fe, got = _port(tmp_path, "both", interleaved=reads["interleaved"],
                    reads1=reads["r1"], reads2=reads["r2_bad"])
    assert got == want


def test_missing_lowq_plane_raises(reads, tmp_path):
    """A masked batch without its quality plane would give unmasked
    counts: it raises instead."""
    fe = FeatureExtractor(FeatureConfig(**FEAT), str(tmp_path / "m"),
                          device="cpu")
    real = fe._group_events

    def no_lowq(*a):
        io, events = real(*a)
        for kind, p in events:
            if kind == "batch":
                p.lowq = None
            yield kind, p

    fe._group_events = lambda *a: ("native", no_lowq(*a))
    with pytest.raises(RuntimeError, match="lowq"):
        fe.extract_features(reads1=reads["r1"], reads2=reads["r2"])
    assert not os.path.exists(fe.marker)


# ---- pipeline --------------------------------------------------------------

PIPE_SIM = dict(n_species=4, genome_len=30_000, n_barcodes=150,
                pairs_per_barcode=30, seed=11, error_rate=0.005,
                low_qual_rate=0.15)


def _clusters(out):
    cluster_of = {}
    with open(os.path.join(out, "3.clustering", "clusters.tsv")) as f:
        for line in f:
            cid, bcs = line.rstrip("\n").split("\t")
            for bc in bcs.split(","):
                cluster_of[bc] = int(cid)
    return cluster_of


def test_paired_pipeline_matches_jax(tmp_path):
    """Steps 1-3 on paired input: ARI vs truth > 0.95 (the JAX gate),
    cross-ARI vs pangaea_tpu's run >= 0.95, and the same bin reads."""
    r1, r2 = str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz")
    res = simulate_linked_reads(out_r1=r1, out_r2=r2, **PIPE_SIM)
    model = dict(epochs=10, batch_size=64, patience=40,
                 eval_every_batches=3)
    out = str(tmp_path / "port")
    Pipeline(PangaeaConfig(reads1=r1, reads2=r2, output=out, steps="1,2,3",
                           feature=FeatureConfig(reads_per_batch=16384),
                           model=ModelConfig(**model),
                           cluster=ClusterConfig(n_clusters=4, n_init=3)),
             device="cpu").run()
    jout = str(tmp_path / "jax")
    JaxPipeline(JaxPangaeaConfig(
        reads1=r1, reads2=r2, output=jout, steps="1,2,3",
        feature=JaxFeatureConfig(reads_per_batch=16384),
        model=JaxModelConfig(**model),
        cluster=JaxClusterConfig(n_clusters=4, n_init=3))).run()
    for step in ("1", "2", "3"):
        assert check_step_finished(out, step)
    mine, theirs = _clusters(out), _clusters(jout)
    labelled = [bc for bc in mine if bc in res.barcode_species]
    assert len(labelled) > 100
    ari = adjusted_rand_score([res.barcode_species[b] for b in labelled],
                              [mine[b] for b in labelled])
    assert ari > 0.95, f"ARI {ari}"
    assert set(mine) == set(theirs)
    common = sorted(mine)
    cross = adjusted_rand_score([mine[b] for b in common],
                                [theirs[b] for b in common])
    assert cross >= 0.95, f"cross-ARI {cross}"
    bins = sorted(f for f in os.listdir(os.path.join(out, "3.clustering"))
                  if f.endswith(".fq"))
    assert len(bins) == 4
    # pangaea_tpu's step 1 on paired input (on the CPU it picks the
    # scatter path) gives the same feature bytes
    for name in ("abundance.k15.v400.w10.m2000.gz", "tnf.m2000.gz"):
        assert _gz(os.path.join(out, "1.features", name)) == \
            _gz(os.path.join(jout, "1.features", name))
