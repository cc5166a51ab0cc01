"""The readers of the program's spans: step 0's sub-stages, step 1's
CSV write, step 2's launch and wait, step 3's k-means and read
extraction. Each reads what the program's dicts carry, per pass, and
nothing where a program leaves them out."""

import json
import os
import shutil

import pytest

import tiny
from benchmark import harness

ROOT = tiny.ROOT
SPAN_METRICS = ["step0.preprocess_s", "step0.interleave_s", "step0.sort_s",
                "step1.save_s", "step2.dispatch_s", "step2.sync_s",
                "step3.rph_s", "step3.extract_s"]


def _metrics(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return {m["name"]: m for m in json.load(f)["per_layer"]}


def _read(name, run, root=ROOT):
    return harness.reader(root, _metrics(root)[name])(run)


def _pass(**kw):
    base = dict(stages={}, step0_s={}, feature_stats={}, train={},
                cluster={}, lloyd_iters=0, skeleton_min=None, out_dir="")
    base.update(kw)
    return harness.Pass(1.0, 1000, **base)


def _run(passes, cell="stlfr-atcc.raw", root=ROOT):
    return harness.Run(harness.load_cell(root, cell), 3.0, 10.0, passes,
                       None, "cpu", {})


def _in_cell(name, cell, root=ROOT):
    """``name``, or its ``.raw`` twin where the cell reports
    ``memory_peak_gb``: the one of the two that lists ``cell``."""
    ms = _metrics(root)
    twin = name + ".raw"
    return twin if twin in ms and cell in ms[twin]["workloads"] else name


def test_the_manifest_names_each_span_metric():
    ms = _metrics()
    for name in SPAN_METRICS:
        m = ms[name]
        if name.startswith("step0."):
            assert (m["unit"], m["source"], m["moves"]) == (
                "s", "program_span", "memory_peak_gb")
            assert m["workloads"] == ["stlfr-atcc.raw"]
            continue
        assert (m["unit"], m["source"], m["moves"]) == (
            "s", "program_span", "reads_per_s")
        assert m["workloads"] == ["10x-atcc.bin", "10x-atcc.deep"]
        raw = ms[name + ".raw"]
        assert raw == dict(m, name=name + ".raw", moves="memory_peak_gb",
                           workloads=["stlfr-atcc.raw"])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_finds_nothing_where_the_program_has_no_span(name):
    # a program without the span: no key in its dicts, or no step at all
    bare = _pass(train={"phase_times": {"build": 0.1, "units": 3}},
                 cluster={"k": 10}, feature_stats={"stream_s": 1.0})
    assert _read(name, _run([bare, _pass()])) is None
    assert _read(name, _run([])) is None


def test_readers_average_over_the_passes():
    a = _pass(step0_s={"preprocess_s": 4.0, "interleave_s": 1.0,
                       "sort_s": 2.0},
              feature_stats={"save_s": 0.5},
              train={"phase_times": {"dispatch": 6.0, "sync": 0.0}},
              cluster={"rph_s": 1.0, "extract_s": 3.0})
    b = _pass(step0_s={"preprocess_s": 6.0, "interleave_s": 3.0,
                       "sort_s": 4.0},
              feature_stats={"save_s": 1.5},
              train={"phase_times": {"dispatch": 8.0, "sync": 0.5}},
              cluster={"rph_s": 2.0, "extract_s": 5.0})
    run = _run([a, b])
    want = {"step0.preprocess_s": 5.0, "step0.interleave_s": 2.0,
            "step0.sort_s": 3.0, "step1.save_s": 1.0,
            "step2.dispatch_s": 7.0, "step2.sync_s": 0.25,
            "step3.rph_s": 1.5, "step3.extract_s": 4.0}
    for name, v in want.items():
        assert _read(name, run) == pytest.approx(v), name
    # step 0's sub-stages are what step0.s sums
    assert _read("step0.s", run) == pytest.approx(
        sum(want[n] for n in SPAN_METRICS[:3]))


@pytest.mark.parametrize("cell", ["10x-atcc.bin", "stlfr-atcc.raw"])
def test_spans_of_a_real_pass_fit_inside_their_steps(cell, tmp_path):
    """One tiny pass on the CPU: every metric the cell lists reads a
    value, step 0's sub-stages sum to ``step0.s``, and each step's
    spans fit inside its seconds."""
    root = tiny.make_root(tmp_path, barcodes=60, epochs=4)
    c = harness.load_cell(root, cell)
    work = str(tmp_path / "work")
    inp, _ = harness.make_inputs(c, 2 ** 31 + 5, work)
    lloyd = harness.Step3Counts()
    try:
        p = harness.run_pass(c, inp, os.path.join(work, "pass0"), "cpu",
                             lloyd)
    finally:
        lloyd.close()
        shutil.rmtree(work, ignore_errors=True)
    run = _run([p], cell, root)
    ms = _metrics(root)
    got = {name: _read(_in_cell(name, cell, root), run, root)
           for name in SPAN_METRICS
           if cell in ms[_in_cell(name, cell, root)]["workloads"]}
    assert all(v is not None and v >= 0 for v in got.values()), got
    if cell == "stlfr-atcc.raw":
        assert sum(got[n] for n in SPAN_METRICS[:3]) == pytest.approx(
            _read("step0.s", run, root), rel=1e-12)
    else:
        assert not any(n.startswith("step0.") for n in got)
    assert got["step2.dispatch_s"] + got["step2.sync_s"] <= _read(
        _in_cell("step2.s", cell, root), run, root)
    assert got["step3.rph_s"] + got["step3.extract_s"] <= _read(
        _in_cell("step3.s", cell, root), run, root)
