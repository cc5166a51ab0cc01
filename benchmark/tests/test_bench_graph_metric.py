"""The reader of step 2's graph counter: ``step2.graph_pct`` reads the
share of units the fused loop replayed, per pass, and nothing where a
program has no such counter."""

import json
import os
import shutil

import pytest

import tiny
from benchmark import harness

ROOT = tiny.ROOT


def _metric(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return {m["name"]: m for m in json.load(f)["per_layer"]}[
            "step2.graph_pct"]


def _read(run, root=ROOT):
    return harness.reader(root, _metric(root))(run)


def _pass(train):
    return harness.Pass(1.0, 1000, {}, {}, {}, train, {}, 0, None, "")


def _run(passes, cell="10x-atcc.bin", root=ROOT):
    return harness.Run(harness.load_cell(root, cell), 3.0, 10.0, passes,
                       None, "cpu", {})


def test_the_manifest_names_the_counter():
    m = _metric()
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "step 2", "reads_per_s")
    assert m["workloads"] == ["10x-atcc.bin", "10x-atcc.deep"]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        raw = {m["name"]: m for m in json.load(f)["per_layer"]}[
            "step2.graph_pct.raw"]
    assert raw == dict(m, name="step2.graph_pct.raw", moves="memory_peak_gb",
                       workloads=["stlfr-atcc.raw"])


def test_reads_the_replayed_share_per_pass():
    a = _pass({"phase_times": {"units": 100, "graph_units": 99}})
    b = _pass({"phase_times": {"units": 50, "graph_units": 48}})
    assert _read(_run([a, b])) == pytest.approx((99.0 + 96.0) / 2)
    eager = _pass({"phase_times": {"units": 100, "graph_units": 0}})
    assert _read(_run([eager])) == 0.0


@pytest.mark.parametrize("train", [
    {"phase_times": {"build": 0.1, "dispatch": 8.0, "units": 100}},
    {"phase_times": {"units": 0, "graph_units": 0}},
    {"val_history": []},
    {},
])
def test_reads_nothing_without_the_counter(train):
    # a program without the counter (or a pass that trained no unit)
    assert _read(_run([_pass(train)])) is None
    assert _read(_run([])) is None


def test_a_cpu_pass_reads_zero(tmp_path):
    """One tiny pass on the CPU: the program reports the counter, and off
    a card no unit is a replay."""
    root = tiny.make_root(tmp_path, barcodes=60, epochs=3)
    c = harness.load_cell(root, "10x-atcc.bin")
    work = str(tmp_path / "work")
    inp, _ = harness.make_inputs(c, 2 ** 31 + 7, work)
    lloyd = harness.Step3Counts()
    try:
        p = harness.run_pass(c, inp, os.path.join(work, "pass0"), "cpu",
                             lloyd)
    finally:
        lloyd.close()
        shutil.rmtree(work, ignore_errors=True)
    pt = p.train["phase_times"]
    assert pt["units"] == 3 and pt["graph_units"] == 0
    assert _read(_run([p], root=root), root) == 0.0
