"""The arithmetic behind the metrics: whole-pass rates, FLOPs, bytes,
and the reduction of a device trace."""

import json
import os

import pytest

from benchmark import flops, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _read(name, run):
    m = [m for k in ("end_to_end", "per_layer") for m in _manifest()[k]
         if m["name"] == name][0]
    return harness.reader(ROOT, m)(run)


def _pass(seconds, reads=1000, **kw):
    base = dict(stages={}, step0_s={}, feature_stats={}, train={},
                cluster={}, lloyd_iters=0, skeleton_min=None, out_dir="")
    base.update(kw)
    return harness.Pass(seconds, reads, **base)


def _run(passes, window_s, trace=None, peaks=None, setup_s=3.0):
    cell = harness.load_cell(ROOT, "10x-atcc.bin")
    return harness.Run(cell, setup_s, window_s, passes, trace,
                       "NVIDIA H100 80GB HBM3", peaks or {})


def test_rate_counts_whole_passes_over_the_whole_window():
    run = _run([_pass(12.0), _pass(13.0), _pass(14.5)], window_s=40.0)
    assert _read("reads_per_s", run) == pytest.approx(3000 / 40.0)
    assert _read("setup_s", run) == 3.0


def test_step_seconds_are_per_pass():
    run = _run([_pass(1, stages={"step2_train": 4.0},
                      step0_s={"sort_s": 1.0, "preprocess_s": 2.0}),
                _pass(1, stages={"step2_train": 6.0}, step0_s={})], 2.0)
    assert _read("step2.s", run) == 5.0
    assert _read("step1.s", run) is None
    assert _read("step0.s", run) == 3.0


def test_vae_flops_by_hand():
    # 536 -> 512 -> 512 -> 32 (x2) and 32 -> 512 -> 512 -> 536
    macs = [536 * 512, 512 * 512, 512 * 32, 512 * 32, 32 * 512, 512 * 512,
            512 * 536]
    fwd = sum(macs)
    train = fwd + sum(macs) + sum(macs[1:])
    embed = 536 * 512 + 512 * 512 + 512 * 32
    got = flops.step2_flops(536, (512, 512), 32, train_rows=10,
                            val_rows=7, embed_rows=3)
    assert got == 2 * (10 * train + 7 * fwd + 3 * embed)


def test_mfu_reads_units_actually_run():
    hist = [(e, 7, 1.0) for e in range(1, 101)]
    p = _pass(1, stages={"step2_train": 10.0},
              train={"val_history": hist, "phase_times": {"units": 100}},
              barcodes_kept=12500)
    run = _run([p], 20.0, peaks={"fp32_flops_per_s": 67e12})
    want = flops.step2_flops(536, (512, 512), 32, 12500 * 100, 8750 * 100,
                             12500) / (10.0 * 67e12) * 100
    assert _read("step2.mfu_pct", run) == pytest.approx(want)
    assert _read("step2.mfu_pct", _run([p], 20.0, peaks={})) is None


def test_scan_bytes_and_roofline():
    assert flops.scan_bytes([10, 20]) == 240
    t = harness.Trace(10.0, 2.0, {"void scan_kernel<Max, false>": 1e-3,
                                  "gemm": 5.0}, [], [2 ** 20] * 100)
    run = _run([_pass(1)], 10.0, trace=t, peaks={"hbm_bytes_per_s": 3.35e12})
    want = 100 * 8 * 2 ** 20 * 100 / 3.35e12 / 1e-3
    assert _read("scan_roofline", run) == pytest.approx(want)
    assert _read("device.idle_pct", run) == pytest.approx(80.0)
    assert _read("scan_roofline", _run([_pass(1)], 10.0)) is None


def test_trace_summary_busy_gaps_and_labels():
    t0 = 1_000
    off = 500  # the device clock runs 500 ns ahead of the host's
    ev = [("marker", t0 + off, t0 + off + 10),
          ("a", 2_000 + off, 3_000 + off), ("b", 2_500 + off, 4_000 + off),
          ("a", 9_000 + off, 9_500 + off)]
    spans = [("step1", 1_500, 4_500), ("step2", 4_500, 10_000)]
    t = harness.summarize(ev, t0, 11_000, spans, [5])
    assert t.busy_s == pytest.approx((2_000 + 500) / 1e9)
    assert t.kernel_s["a"] == pytest.approx(1_500 / 1e9)
    assert t.window_s == pytest.approx(10_000 / 1e9)
    assert t.idle_gaps == [["step2", 5_000 / 1e9]]


def test_peak_memory_in_gb_and_the_raw_wall_rate():
    cell = harness.load_cell(ROOT, "stlfr-atcc.raw")
    run = harness.Run(cell, 3.0, 40.0, [_pass(12.0), _pass(13.0)], None,
                      "cpu", {}, 3_410_182_656)
    assert _read("memory_peak_gb", run) == 3.410182656
    assert _read("reads_per_s.raw", run) == pytest.approx(2000 / 40.0)
    assert _read("memory_peak_gb", harness.Run(
        cell, 3.0, 40.0, [_pass(12.0)], None, "cpu", {})) is None


def test_raw_twins_read_what_their_bases_read():
    p = _pass(1, stages={"step1_features": 2.0, "step2_train": 4.0,
                         "step3_cluster": 3.0},
              feature_stats={"stream_s": 1.5, "save_s": 0.5},
              train={"phase_times": {"dispatch": 2.0, "sync": 0.1,
                                     "units": 10, "graph_units": 9}},
              cluster={"rph_s": 1.0, "extract_s": 1.5})
    t = harness.Trace(10.0, 2.0, {"void scan_kernel<Max, false>": 1e-3},
                      [], [1000])
    run = _run([p], 20.0, trace=t, peaks={"hbm_bytes_per_s": 3.35e12})
    twins = [m["name"] for m in _manifest()["per_layer"]
             if m["name"].endswith(".raw") and m["name"] != "reads_per_s.raw"]
    for name in twins:
        assert _read(name, run) == _read(name[:-len(".raw")], run), name
    assert sum(_read(n, run) is not None for n in twins) >= 10
