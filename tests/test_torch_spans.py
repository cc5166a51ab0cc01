"""The span recorder (``pangaea_tpu_torch.profiling``): nesting and
parents on every thread, nothing kept and no profiler range entered
while recording is off and no trace runs, and the spans of steps 0-3,
whose totals are the seconds the pipeline's own dicts report."""

import argparse
import os
import threading

import pytest

from pangaea_tpu_torch import profiling
from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.config import (ClusterConfig, FeatureConfig,
                                      ModelConfig, PangaeaConfig)
from pangaea_tpu_torch.io import sim as tsim
from pangaea_tpu_torch.pipeline import driver
from pangaea_tpu_torch.pipeline.run import Pipeline
from pangaea_tpu_torch.profiling import span


@pytest.fixture
def recorder():
    """Recording on, with nothing left over from earlier spans; off and
    emptied again afterwards."""
    profiling.take_records()
    profiling.take_totals()
    profiling.set_recording(True)
    yield profiling
    profiling.set_recording(False)
    profiling.take_records()
    profiling.take_totals()


def _same(a, b):
    return a == pytest.approx(b, rel=1e-9, abs=1e-12)


def test_spans_nest_per_thread(recorder):
    seen = {}

    def worker():
        seen["tid"] = threading.get_ident()
        with span("w.outer"):
            with span("w.inner"):
                pass

    with span("outer") as outer:
        with span("mid"):
            with span("inner"):
                pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        with span("mid"):
            pass
    assert not t.is_alive()
    recs = recorder.take_records()
    by = {}
    for name, parent, tid, s, e in recs:
        by.setdefault(name, []).append((parent, tid, s, e))
        assert s <= e
    main = threading.get_ident()
    assert [r[:2] for r in by["outer"]] == [(None, main)]
    assert [r[:2] for r in by["mid"]] == [("outer", main)] * 2
    assert [r[:2] for r in by["inner"]] == [("mid", main)]
    # a worker thread starts its own stack: its outermost span has no
    # parent, though the main thread had spans open
    assert [r[:2] for r in by["w.outer"]] == [(None, seen["tid"])]
    assert [r[:2] for r in by["w.inner"]] == [("w.outer", seen["tid"])]
    # records close innermost first, and a child lies inside its parent
    assert [r[0] for r in recs][-1] == "outer"
    (_, _, so, eo), = by["outer"]
    assert all(so <= s <= e <= eo for _, _, s, e in by["inner"])
    totals = recorder.take_totals()
    assert _same(totals["outer"], outer.seconds)
    assert _same(totals["mid"], sum(e - s for _, _, s, e in by["mid"]) / 1e9)
    assert recorder.take_totals() == {} and recorder.take_records() == []


def test_spans_on_many_threads_lose_no_update(recorder):
    """More threads than cores close spans of one name at a short switch
    interval: every record is kept and the name's total is their sum."""
    import sys
    n_threads, n_spans = (os.cpu_count() or 1) + 3, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # all threads are alive at once, so no two share an ident
        gate = threading.Barrier(n_threads, timeout=60)

        def work():
            gate.wait()
            for _ in range(n_spans):
                with span("busy"):
                    pass
            gate.wait()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = recorder.take_records()
    assert len(recs) == n_threads * n_spans
    assert {(r[0], r[1]) for r in recs} == {("busy", None)}
    assert len({r[2] for r in recs}) == n_threads
    total_ns = sum(e - s for _, _, _, s, e in recs)
    assert recorder.take_totals()["busy"] == pytest.approx(total_ns / 1e9,
                                                          rel=1e-12)


def test_span_records_its_time_when_the_block_raises(recorder):
    with pytest.raises(KeyError):
        with span("fails"):
            with span("fails.inner"):
                raise KeyError("x")
    with span("after"):
        pass
    recs = recorder.take_records()
    assert [(r[0], r[1]) for r in recs] == [("fails.inner", "fails"),
                                            ("fails", None), ("after", None)]


def test_recording_off_keeps_no_records_and_enters_no_profiler_range(
        tmp_path, monkeypatch):
    """Outside trace() a span never enters record_function, recording or
    not; inside it every span opens a range of its name. With recording
    off no record is kept, but the totals still grow."""
    import torch.profiler
    entered = []
    real = torch.profiler.record_function

    class counting(real):
        def __init__(self, name, *a, **kw):
            entered.append(name)
            super().__init__(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.delenv(profiling.TRACE_ENV, raising=False)
    profiling.take_records()
    profiling.take_totals()
    profiling.set_recording(False)
    with span("quiet"):
        with span("quiet.inner"):
            pass
    with profiling.trace("pipeline"):  # no trace dir: no profiler
        with span("quiet"):
            pass
    assert entered == []
    assert profiling.take_records() == []
    assert set(profiling.take_totals()) == {"quiet", "quiet.inner"}
    with profiling.trace("pipeline", trace_dir=str(tmp_path / "t")):
        with span("traced"):
            pass
    assert entered == ["pipeline", "traced"]
    with span("quiet"):
        pass
    assert entered == ["pipeline", "traced"]
    assert profiling.take_records() == []
    profiling.take_totals()


def _tiny_pipeline(tmp_path):
    reads = str(tmp_path / "reads.fq.gz")
    tsim.simulate_linked_reads(out_interleaved=reads, n_species=3,
                               genome_len=12_000, n_barcodes=60,
                               pairs_per_barcode=20, seed=3)
    cfg = PangaeaConfig(
        interleaved_reads=reads, output=str(tmp_path / "out"),
        steps="1,2,3", feature=FeatureConfig(reads_per_batch=4096),
        model=ModelConfig(epochs=4, batch_size=32, patience=40,
                          eval_every_batches=2),
        cluster=ClusterConfig(n_clusters=3, n_init=2))
    return Pipeline(cfg, device="cpu")


def test_pipeline_spans_feed_its_stats(tmp_path, recorder):
    pipe = _tiny_pipeline(tmp_path)
    pipe.run()
    recs = recorder.take_records()
    totals = recorder.take_totals()
    names = {r[0] for r in recs}
    assert {"step1.stream", "step1.sortjoin", "step1.replay", "step1.save",
            "step2.setup", "step2.build", "step2.dispatch", "step2.sync",
            "step2.ckpt", "step2.latent", "step3.rph",
            "step3.extract"} <= names
    assert set(totals) == names
    main = threading.get_ident()
    parent = {r[0]: r[1] for r in recs}
    tid = {r[0]: r[2] for r in recs}
    # the step-1 CSV write runs on its own thread, behind step 2
    assert tid["step1.save"] != main and parent["step1.save"] is None
    assert all(tid[n] == main for n in names - {"step1.save"})
    for name in ("step1.stream", "step1.sortjoin", "step1.replay"):
        assert parent[name] == "step1_features"
    for name in ("step2.setup", "step2.fit", "step2.latent"):
        assert parent[name] == "step2_train"
    for name in ("step2.build", "step2.dispatch", "step2.sync"):
        assert parent[name] == "step2.fit"
    assert parent["step3.rph"] == parent["step3.extract"] == "step3_cluster"

    fs = pipe.feature_extractor.stats
    for key, name in (("stream_s", "step1.stream"),
                      ("sortjoin_s", "step1.sortjoin"),
                      ("replay_s", "step1.replay"),
                      ("save_s", "step1.save")):
        assert _same(fs[key], totals[name]), key
    pt = pipe.train_stats["phase_times"]
    for key in ("build", "dispatch", "sync"):
        assert _same(pt[key], totals["step2." + key]), key
    assert _same(pt["ckpt_io"], totals["step2.ckpt"])
    assert pt["units"] > 0 and pt["chunks"] > 0
    for key in ("setup", "fit", "latent"):
        assert _same(pipe.train_stats[key + "_s"], totals["step2." + key])
    cs = pipe.cluster_stats
    assert _same(cs["rph_s"], totals["step3.rph"])
    assert _same(cs["extract_s"], totals["step3.extract"])
    for stage, st in pipe.timer.stages.items():
        assert _same(st.seconds, totals[stage]), stage


def _step0_args(kind, tmp_path):
    if kind == "stlfr":
        paths = [str(tmp_path / f) for f in ("r1.fq", "r2.fq", "wl.txt")]
        tsim.simulate_stlfr_raw(*paths, n_species=2, genome_len=6_000,
                                n_partitions=40, pairs_per_partition=6,
                                read_len=80, insert_len=200, n_wl=24,
                                seed=5)
        r1, r2, wl = paths
        return argparse.Namespace(
            short_type="stlfr", reads1=r1, reads2=r2, whitelist=wl,
            longreads="", index="", output=str(tmp_path), threads=2)
    from tests.test_hybrid_e2e import make_hybrid_data
    long_fq, r1, r2, _ = make_hybrid_data(tmp_path)
    return argparse.Namespace(
        short_type="short", reads1=r1, reads2=r2, longreads=long_fq,
        index="", whitelist="", output=str(tmp_path), threads=2,
        device="cpu")


@pytest.mark.parametrize("kind,keys", [
    ("stlfr", {"preprocess_s", "interleave_s", "sort_s"}),
    ("hybrid", {"barcode_map_s", "short2long_s", "add_barcode_s",
                "assign_s", "sort_s"}),
])
def test_step0_seconds_are_its_span_totals(kind, keys, tmp_path, recorder,
                                           monkeypatch):
    monkeypatch.setattr(ToolRunner, "available", lambda self, tool: False)
    args = _step0_args(kind, tmp_path)
    stats = {}
    driver.preprocess_reads(args, str(tmp_path / "0_preprocess_reads"),
                            ToolRunner(), stats=stats)
    totals = recorder.take_totals()
    assert set(stats) == keys
    assert set(totals) == {"step0." + k[:-2] for k in keys}
    for key in keys:
        assert _same(stats[key], totals["step0." + key[:-2]]), key


def _span_idle():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "span_idle.py")
    spec = importlib.util.spec_from_file_location("span_idle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_inside_spans_and_gap_labels():
    """tools/span_idle.py on synthetic device events: the idle seconds
    inside each span and each gap labelled by the innermost span of the
    main thread that covers its midpoint."""
    m = _span_idle()
    off = 700  # the device clock runs 700 ns ahead of the host's
    t0 = 1_000
    ev = [("marker", t0 + off, t0 + off + 5),
          ("a", 2_000 + off, 3_000 + off), ("b", 2_500 + off, 4_000 + off),
          ("c", 6_000 + off, 6_500 + off), ("d", 9_000 + off, 9_200 + off)]
    main, other = 1, 2
    recs = [("step2.dispatch", "step2.fit", main, 1_500, 5_000),
            ("step2.fit", "step2_train", main, 1_000, 8_000),
            ("step2_train", None, main, 900, 8_500),
            ("step1.save", None, other, 4_000, 10_000),
            ("step2.dispatch", "step2.fit", main, 5_500, 7_000)]
    spans, gaps = m.attribute(ev, t0, recs, main)
    # busy: [2000, 4000], [6000, 6500], [9000, 9200]
    d = spans["step2.dispatch"]
    assert d["n"] == 2
    assert d["s"] == pytest.approx((3_500 + 1_500) / 1e9)
    assert d["idle_s"] == pytest.approx((1_500 + 1_000) / 1e9)
    assert spans["step1.save"]["idle_s"] == pytest.approx(
        (6_000 - 700) / 1e9)
    # the gap 6500-9000 (midpoint 7750) lies in step2.fit, not in the
    # dispatch; 4000-6000 (5000) in a dispatch; 9000+ in no span of the
    # main thread, though the save thread's covers it
    assert gaps == [["step2.fit", 2_500 / 1e9],
                    ["step2.dispatch", 2_000 / 1e9]]
    ev.append(("e", 12_000 + off, 12_100 + off))
    assert m.attribute(ev, t0, recs, main)[1][0] == ["outside", 2_800 / 1e9]


@pytest.mark.parametrize("a,b,want", [
    (0, 100, 0), (150, 170, 20), (100, 400, 200), (250, 320, 20),
    (120, 1_000, 230), (500, 600, 0), (300, 300, 0)])
def test_busy_time_within_an_interval(a, b, want):
    busy = _span_idle().Busy([(100, 200), (300, 400), (700, 750)])
    assert busy.within(a, b) == want
