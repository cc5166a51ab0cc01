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
