"""PyTorch port vs pangaea_tpu: step 1 past the device window cap.

The spill kernels must be bit-equal to pangaea_tpu's where its host
reads them (run ids in stream order, the unique prefix of keys and
weight sums, the run counts, the run-bin gather), and step 1 with a
lowered ``sortjoin_max_windows`` must write pangaea_tpu's feature CSV
bytes (hist_impl='sortjoin') through every spill path: the aggregated
spill with each run-id store (device, host, disk), the device-budget
demotion, the raw ranged join, a mid-stream overflow, paired masked
input, and the overlong-read retry.
"""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangaea_tpu_torch.features as tfeat
from pangaea_tpu.config import FeatureConfig as JaxFeatureConfig
from pangaea_tpu.features import FeatureExtractor as JaxFeatureExtractor
from pangaea_tpu.kernels import features as jkf
from pangaea_tpu_torch.config import FeatureConfig
from pangaea_tpu_torch.features import FeatureExtractor
from pangaea_tpu_torch.io.sim import simulate_linked_reads
from pangaea_tpu_torch.kernels import features as tkf

SIM = dict(n_species=3, genome_len=12_000, n_barcodes=200,
           pairs_per_barcode=12, read_len=90, error_rate=0.01,
           low_qual_rate=0.1, seed=29)
FEAT = dict(reads_per_batch=512)
CAP = 1 << 17   # ~4 ranges and ~4 aggregation chunks at this input


def _gz(path):
    with gzip.open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spill")
    fq, r1, r2 = (str(d / n) for n in ("i.fq.gz", "r1.fq.gz", "r2.fq.gz"))
    simulate_linked_reads(out_interleaved=fq, **SIM)
    simulate_linked_reads(out_r1=r1, out_r2=r2, **SIM)
    return {"interleaved": dict(interleaved=fq),
            "paired": dict(reads1=r1, reads2=r2)}


@pytest.fixture(scope="module")
def jax_bytes(reads, tmp_path_factory):
    """pangaea_tpu's in-cap feature CSV bytes per input form."""
    d = tmp_path_factory.mktemp("jax_spill")
    out = {}
    for form, inp in reads.items():
        fe = JaxFeatureExtractor(JaxFeatureConfig(hist_impl="sortjoin",
                                                  **FEAT), str(d / form))
        fe.extract_features(**inp)
        out[form] = (_gz(fe.abd_gz), _gz(fe.tnf_gz))
    return out


def _port(tmp_path, tag, inp, **cfg):
    fe = FeatureExtractor(FeatureConfig(**FEAT, **cfg), str(tmp_path / tag),
                          device="cpu")
    fe.extract_features(**inp)
    return fe, (_gz(fe.abd_gz), _gz(fe.tnf_gz))


# ---- kernels -------------------------------------------------------------

def _chunk(seed, n=6000, k=4):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 150, n).astype(np.int32)
    keys[rng.rand(n) < 0.15] = 4 ** k
    w = (rng.rand(n) < 0.6).astype(np.int32)
    w[keys == 4 ** k] = 0
    return keys, w


@pytest.mark.parametrize("weighted", [False, True])
def test_spill_aggregate_bit_equal(weighted):
    keys, w = _chunk(3 + weighted)
    if weighted:
        want = jkf.spill_aggregate_weighted(jnp.asarray(keys),
                                            jnp.asarray(w), k=4)
        got = tkf.spill_aggregate_weighted(torch.from_numpy(keys),
                                           torch.from_numpy(w), k=4)
    else:
        want = jkf.spill_aggregate(jnp.asarray(keys), k=4)
        got = tkf.spill_aggregate(torch.from_numpy(keys), k=4)
    w_ids, (w_uniq,), w_uw, w_runs, w_valid = want
    ids, uniq, uw, n_runs, n_valid = got
    assert (n_runs, n_valid) == (int(w_runs), int(w_valid))
    assert n_runs == n_valid + 1  # one sentinel run
    np.testing.assert_array_equal(ids.numpy(), np.asarray(w_ids))
    np.testing.assert_array_equal(uniq[:n_valid].numpy(),
                                  np.asarray(w_uniq)[:n_valid])
    np.testing.assert_array_equal(uw[:n_valid].numpy(),
                                  np.asarray(w_uw)[:n_valid])


def test_map_run_bins_equal_jax():
    rng = np.random.RandomState(7)
    table = np.full(256, -1, np.int32)   # pangaea_tpu pads to 128s
    table[:200] = rng.randint(-1, 40, 200)
    run_ids = rng.randint(0, 200, 5000).astype(np.int32)
    want = np.asarray(jkf.map_run_bins(jnp.asarray(table),
                                       jnp.asarray(run_ids)))
    got = tkf.map_run_bins(torch.from_numpy(table[:200].copy()),
                           torch.from_numpy(run_ids))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- feature CSVs ----------------------------------------------------------

@pytest.mark.parametrize("store", ["device", "host", "disk"])
def test_aggregated_spill_csv_bytes_equal_jax(reads, jax_bytes, tmp_path,
                                              store):
    spill_dir = str(tmp_path / "spill") if store == "disk" else None
    fe, got = _port(tmp_path, store, reads["interleaved"],
                    sortjoin_max_windows=CAP, spill_store=store,
                    spill_dir=spill_dir)
    assert (fe.stats["spill"], fe.stats["store"]) == ("agg", store)
    assert fe.stats["spill_chunks"] > 2
    assert got == jax_bytes["interleaved"]
    if spill_dir:
        assert os.listdir(spill_dir) == []   # the store is removed


def test_aggregated_spill_device_budget_demotes_to_host(reads, jax_bytes,
                                                        tmp_path):
    fe, got = _port(tmp_path, "budget", reads["interleaved"],
                    sortjoin_max_windows=CAP, spill_store="device",
                    spill_device_budget=300_000)
    assert (fe.stats["spill"], fe.stats["store"]) == ("agg", "host")
    assert got == jax_bytes["interleaved"]


@pytest.mark.parametrize("form", ["interleaved", "paired"])
def test_raw_spill_csv_bytes_equal_jax(reads, jax_bytes, tmp_path, form):
    fe, got = _port(tmp_path, form, reads[form], sortjoin_max_windows=CAP,
                    spill_agg="off")
    assert fe.stats["spill"] == "raw" and fe.stats["ranges"] >= 3
    assert got == jax_bytes[form]


def test_paired_masked_aggregated_spill_csv_bytes_equal_jax(
        reads, jax_bytes, tmp_path):
    fe, got = _port(tmp_path, "pagg", reads["paired"],
                    sortjoin_max_windows=CAP)
    assert fe.stats["spill"] == "agg"
    assert got == jax_bytes["paired"]


@pytest.mark.parametrize("impl", ["auto", "off"])
def test_midstream_overflow_csv_bytes_equal_jax(reads, jax_bytes, tmp_path,
                                                monkeypatch, impl):
    """When the up-front estimate lowballs, the spill engages mid-stream
    (collected device keys move to the aggregation or to host RAM) and
    the stream is still read once."""
    monkeypatch.setattr(FeatureExtractor, "_estimate_stream_windows",
                        lambda self, path: 10)
    opened = []
    real = tfeat.native_group_events

    def counting(path, *a, **k):
        opened.append(path)
        return real(path, *a, **k)

    monkeypatch.setattr(tfeat, "native_group_events", counting)
    fe, got = _port(tmp_path, impl, reads["interleaved"],
                    sortjoin_max_windows=CAP, spill_agg=impl)
    assert fe.stats["spill"] == ("agg" if impl == "auto" else "raw")
    assert len(opened) == 1
    assert got == jax_bytes["interleaved"]


def test_overlong_read_retry(reads, jax_bytes, tmp_path, monkeypatch):
    """A sampled row width below the reads makes the native stream raise;
    step 1 reruns once at max_read_len and still matches."""
    monkeypatch.setattr(FeatureExtractor, "_auto_row_len",
                        lambda self, *a, **k: 32)
    fe, got = _port(tmp_path, "retry", reads["interleaved"])
    assert fe.row_len == FeatureConfig().max_read_len
    assert got == jax_bytes["interleaved"]


def test_spill_store_disk_needs_a_directory(reads, tmp_path):
    with pytest.raises(ValueError, match="spill_dir"):
        _port(tmp_path, "nodir", reads["interleaved"],
              sortjoin_max_windows=CAP, spill_store="disk")


# ---- weight sums past 2^31 - 1 ---------------------------------------------
#
# pangaea_tpu forms run weight sums from an int32 cumsum, which wraps once
# the weights joined in one call pass 2^31 - 1, so it cannot be the oracle
# here: an int64 numpy count is.

def _oracle_bins(keys, weights, k, window=10, vector_size=400):
    keys = np.asarray(keys, np.int64)
    uk, inv = np.unique(keys, return_inverse=True)
    tot = np.zeros(len(uk), np.int64)
    np.add.at(tot, inv, np.asarray(weights, np.int64))
    cnt = tot[inv]
    b = cnt // window
    ok = (keys < 4 ** k) & (cnt > 0) & (b < vector_size)
    return np.where(ok, b, -1).astype(np.int32)


@pytest.mark.parametrize("k", [15, 21])
def test_weighted_join_past_int32_total(k):
    """82 keys weighted 50, 80 x 30,000,000 and 50 (total 2,400,000,100):
    the two keys of count 50 get bin 5."""
    dt = np.int64 if k > 15 else np.int32
    keys = (np.arange(82) * 7919).astype(dt)
    w = np.array([50] + [30_000_000] * 80 + [50], np.int32)
    got = tkf.sortjoin_bins_weighted(torch.from_numpy(keys),
                                     torch.from_numpy(w), k=k, window=10,
                                     vector_size=400)
    assert got.dtype == torch.int32
    assert (int(got[0]), int(got[-1])) == (5, 5)
    np.testing.assert_array_equal(got.numpy(), _oracle_bins(keys, w, k))


def _heavy_groups(seed, n_chunks=3, n=300):
    """Chunks of unique sorted keys (overlapping across chunks) with int32
    run weights: a third heavy (2^28..2^30), the rest light, so any key
    range or disk bucket holds more than 2^31 - 1 in all."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_chunks):
        keys = np.sort(rng.choice(1000, n, replace=False)).astype(np.int32)
        heavy = rng.rand(n) < 0.35
        w = np.where(heavy, rng.randint(2 ** 28, 2 ** 30, n),
                     rng.randint(1, 200, n)).astype(np.int32)
        out.append((keys, w))
    return out


def test_chunked_sortjoin_weighted_past_int32_total(tmp_path):
    parts = _heavy_groups(41)
    fe = FeatureExtractor(FeatureConfig(sortjoin_max_windows=200),
                          str(tmp_path), device="cpu")
    got = fe._chunked_sortjoin_bins(parts, weighted=True)
    assert fe._last_ranges >= 4
    keys = np.concatenate([p[0] for p in parts])
    w = np.concatenate([p[1] for p in parts])
    assert w.astype(np.int64).sum() > 10 * 2 ** 31
    want = _oracle_bins(keys, w, 15)
    assert (want >= 0).sum() > 100
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("store,cap", [("device", 1 << 20), ("device", 200),
                                       ("disk", 1 << 20)])
def test_spill_finalize_bins_past_int32_total(tmp_path, store, cap):
    """Phase B of the weighted spill on synthetic chunks: the device join
    (within the cap), the host ranged join (past it) and the disk
    buckets give the int64 count's bins."""
    parts = _heavy_groups(43)
    cfg = FeatureConfig(sortjoin_max_windows=cap, spill_store=store,
                        spill_dir=str(tmp_path / "sp") if store == "disk"
                        else None)
    agg = tfeat._SpillAgg(FeatureExtractor(cfg, str(tmp_path), device="cpu"),
                          weighted=True, per_batch=1)
    for c, (keys, w) in enumerate(parts):
        g = {"n_windows": len(keys), "n_runs": len(keys),
             "n_valid": len(keys), "bins_table": None}
        if store == "disk":
            agg._bucket_append(keys, w, c)
        else:
            g.update(uniq=torch.from_numpy(keys), uw=torch.from_numpy(w))
        agg.groups.append(g)
    agg.finalize_bins()
    got = [g["bins_table"] for g in agg.groups]
    got = np.concatenate([np.load(t) if isinstance(t, str) else t.numpy()
                          for t in got])
    agg.cleanup()
    want = _oracle_bins(np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]), 15)
    np.testing.assert_array_equal(got, want)
