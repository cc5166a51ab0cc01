"""PyTorch port vs pangaea_tpu: step 1 split over gloo ranks at world
sizes 1, 2 and 3 — ``parallel.ShardedFeatureExtractor`` on the three
histogram paths, at k = 21, on masked paired input at k = 9 and 21, and
past the window cap — and tests/multihost_worker.py's multi-process flow
(split, partial table, ``allreduce_table``, group features,
``allgather_rows``). Each world size runs every case in one set of
spawned ranks (tests/torch_dist_workers.py), joined under a timeout.

Every case's CSVs (written by rank 0) are byte-equal, decompressed, to
pangaea_tpu's one-device extractor's on the same simulated reads.
"""

import gzip
import os

import numpy as np
import pytest

from tests import torch_dist_workers as W

WORLDS = (1, 2, 3)
SPILL = dict(kmer=9, tnf_kmer=4, min_length=100, max_read_len=64,
             reads_per_batch=64, hist_impl="sortjoin", min_qual_char=None)
# the spill sim's ~18k-32k windows: past the cap on one rank, within
# the cap scaled by three
MESH_CAP = 12_000


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The simulated inputs, pangaea_tpu's CSV bytes for each, and the
    port's cases (name, FeatureConfig kwargs, inputs, truth key)."""
    from pangaea_tpu.config import FeatureConfig
    from pangaea_tpu.features import FeatureExtractor
    from pangaea_tpu.io.sim import simulate_linked_reads
    d = tmp_path_factory.mktemp("pfeat")
    sims = {
        "i17": dict(out_interleaved=str(d / "i17.fq.gz"), n_species=2,
                    genome_len=8_000, n_barcodes=40, pairs_per_barcode=12,
                    seed=17),
        "i23": dict(out_interleaved=str(d / "i23.fq.gz"), n_species=2,
                    genome_len=8_000, n_barcodes=40, pairs_per_barcode=12,
                    seed=23),
        "p19": dict(out_r1=str(d / "p19_1.fq.gz"),
                    out_r2=str(d / "p19_2.fq.gz"), n_species=2,
                    genome_len=8_000, n_barcodes=40, pairs_per_barcode=12,
                    error_rate=0.005, low_qual_rate=0.15, seed=19),
        "s7": dict(out_interleaved=str(d / "s7.fq.gz"), n_species=2,
                   genome_len=8_000, n_barcodes=24, pairs_per_barcode=12,
                   read_len=40, seed=7),
    }
    for kw in sims.values():
        simulate_linked_reads(**kw)
    inputs = {k: ({"interleaved": kw["out_interleaved"]}
                  if "out_interleaved" in kw else
                  {"reads1": kw["out_r1"], "reads2": kw["out_r2"]})
              for k, kw in sims.items()}

    truths = {}

    def truth(key, sim, **cfg):
        fe = FeatureExtractor(FeatureConfig(**cfg), str(d / f"jax_{key}"))
        fe.extract_features(**inputs[sim])
        truths[key] = tuple(gzip.open(p).read()
                            for p in (fe.abd_gz, fe.tnf_gz))

    truth("i17", "i17", kmer=9, reads_per_batch=512)
    truth("i23", "i23", kmer=21, reads_per_batch=512)
    for k in (9, 21):
        truth(f"p19k{k}", "p19", kmer=k, reads_per_batch=512,
              hist_impl="sortjoin", min_qual_char="?")
    truth("s7", "s7", **dict(SPILL, reads_per_batch=32,
                             hist_impl="scatter"))
    cases = [(f"i17_{impl}", dict(kmer=9, reads_per_batch=512,
                                  hist_impl=impl), inputs["i17"], "i17")
             for impl in ("scatter", "segsum", "sortjoin")]
    cases += [("i23_k21", dict(kmer=21, reads_per_batch=512),
               inputs["i23"], "i23")]
    cases += [(f"p19_k{k}", dict(kmer=k, reads_per_batch=512,
                                 hist_impl="sortjoin", min_qual_char="?"),
               inputs["p19"], f"p19k{k}") for k in (9, 21)]
    cases += [("s7_meshcap", dict(SPILL, sortjoin_max_windows=MESH_CAP),
               inputs["s7"], "s7"),
              ("s7_spill", dict(SPILL, sortjoin_max_windows=500),
               inputs["s7"], "s7")]
    return str(d), cases, truths


@pytest.fixture(scope="module", params=WORLDS)
def features_run(request, data, tmp_path_factory):
    _, cases, _ = data
    world = request.param
    out = str(tmp_path_factory.mktemp("prun"))
    results = W.run_world(W.features_battery, world, out,
                          [(n, cfg, inp) for n, cfg, inp, _ in cases], out)
    return world, results


CASES = ["i17_scatter", "i17_segsum", "i17_sortjoin", "i23_k21", "p19_k9",
         "p19_k21", "s7_meshcap", "s7_spill"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_feature_extractor_csv_bytes(features_run, data, case):
    """Rank 0's CSVs == pangaea_tpu's one-device CSVs, byte for byte
    (decompressed), and every rank returns the same matrices; only rank
    0 writes."""
    world, results = features_run
    _, cases, truths = data
    key = {n: t for n, _, _, t in cases}[case]
    r0 = results[0][case]
    got = tuple(gzip.open(p).read() for p in (r0["abd_gz"], r0["tnf_gz"]))
    assert got[0] == truths[key][0]
    assert got[1] == truths[key][1]
    assert r0["reads_per_batch"] % world == 0
    for r in results[1:]:
        assert r[case]["names"] == r0["names"]
        np.testing.assert_array_equal(r[case]["abd"], r0["abd"])
        np.testing.assert_array_equal(r[case]["tnf"], r0["tnf"])


def test_sharded_paths_ran(features_run):
    """The table paths ran the sharded counter; the sort-join ran in cap
    at the mesh-scaled cap once three ranks hold the windows; past even
    that cap the raw spill joined several key ranges (the aggregated
    spill stays off: its joins would not be collective)."""
    world, results = features_run
    r0 = results[0]
    assert r0["i17_scatter"]["stats"]["path"] == "table"
    assert r0["i17_segsum"]["stats"]["path"] == "table"
    assert r0["i17_sortjoin"]["stats"]["path"] == "sortjoin"
    mesh = r0["s7_meshcap"]["stats"]["spill"]
    if world == 1:
        assert mesh == "raw"
    if world == 3:
        assert mesh == "none"
    spill = r0["s7_spill"]["stats"]
    assert spill["spill"] == "raw" and spill["ranges"] > 1
    for r in results:
        assert r["s7_spill"]["stats"]["ranges"] == spill["ranges"]


# ---- the multi-process flow -----------------------------------------------------


MH_CFG = dict(kmer=9, min_length=100, max_read_len=64, reads_per_batch=32,
              hist_impl="scatter", min_qual_char=None, auto_row_len=False,
              bug_compat_boundary_leak=False)


@pytest.fixture(scope="module")
def mh_data(tmp_path_factory):
    from pangaea_tpu.config import FeatureConfig
    from pangaea_tpu.features import FeatureExtractor
    from pangaea_tpu.io.sim import simulate_linked_reads
    d = tmp_path_factory.mktemp("mh")
    fq = str(d / "reads.fq")
    simulate_linked_reads(out_interleaved=fq, n_species=3,
                          genome_len=20_000, n_barcodes=40,
                          pairs_per_barcode=8, read_len=48, seed=9)
    fe = FeatureExtractor(FeatureConfig(**MH_CFG), str(d / "single"))
    names, abd, tnf = fe.extract_features(interleaved=fq)
    table = np.asarray(fe.global_kmer_table(interleaved=fq))
    return str(d), fq, (np.asarray(names, dtype="U"), abd, tnf,
                        int(table.sum(dtype=np.int64)))


@pytest.mark.parametrize("world", WORLDS)
def test_multiprocess_flow_matches_single(mh_data, world, tmp_path):
    """Split at barcode boundaries, per-rank partial table,
    allreduce_table, group features against the merged table and the
    ragged allgather_rows == pangaea_tpu's one-process run over the
    whole file; three shards of 40 barcodes are ragged."""
    _, fq, (names, abd, tnf, table_sum) = mh_data
    rs = W.run_world(W.multihost_flow, world, str(tmp_path), fq,
                     str(tmp_path), MH_CFG)
    for r in rs:
        assert r["table_sum"] == table_sum
        np.testing.assert_array_equal(r["all_abd"], abd.astype(np.float32))
        np.testing.assert_array_equal(r["all_tnf"], tnf.astype(np.float32))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(r["names"], dtype="U") for r in rs]),
        names)
    np.testing.assert_array_equal(np.concatenate([r["abd"] for r in rs]),
                                  abd)
    np.testing.assert_array_equal(np.concatenate([r["tnf"] for r in rs]),
                                  tnf)
    sizes = [len(r["names"]) for r in rs]
    assert all(s > 0 for s in sizes)
    if world == 3:
        assert len(set(sizes)) > 1, f"shards not ragged: {sizes}"
