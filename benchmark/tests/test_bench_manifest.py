"""BENCHMARK.json keeps to its contract, and every name is found."""

import ast
import glob
import json
import os
import re
import sys

from benchmark import harness, run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys():
    man = _manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        names.append(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_and_metric_is_found_by_name():
    man = _manifest()
    for w in man["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(ROOT, m))
        assert set(cell.config["reduced"]) == set(
            [c for c in man["configs"] if c["name"] == w["config"]][0]
            ["reduced"])


def test_the_deep_cell_is_bin_at_twice_the_pairs():
    deep = harness.load_cell(ROOT, "10x-atcc.deep")
    bin_ = harness.load_cell(ROOT, "10x-atcc.bin")
    assert (deep.chips, deep.config) == (1, bin_.config)
    assert deep.traffic == dict(bin_.traffic, pairs_per_barcode=80)
    assert deep.end_to_end == bin_.end_to_end
    for m in _manifest()["per_layer"]:
        if "10x-atcc.bin" in m.get("workloads", ["10x-atcc.bin"]):
            assert "10x-atcc.deep" in m.get("workloads", ["10x-atcc.deep"]), \
                m["name"]
    assert [m["name"] for m in deep.per_layer] == [
        m["name"] for m in bin_.per_layer]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_a_program_free_reference():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                          recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path
    for path in [os.path.join(ROOT, "benchmark", name + ".py") for name in
                 ("reference", "compare", "gen", "flops")] + glob.glob(
                     os.path.join(ROOT, "benchmark", "platforms", "*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "pangaea_tpu_torch" not in tops, path


def test_the_module_check_compares_whole_top_level_names():
    before = dict(sys.modules)
    try:
        sys.modules["pangaea_tpu_torch_x.y"] = sys
        assert "pangaea_tpu" not in run.forbidden_modules()
        sys.modules["pangaea_tpu.io"] = sys
        assert run.forbidden_modules() == ["pangaea_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_every_per_layer_metric_moves_what_its_cells_report():
    man = _manifest()
    for w in man["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    raw = harness.load_cell(ROOT, "stlfr-atcc.raw")
    assert {m["name"] for m in raw.end_to_end} == {"memory_peak_gb",
                                                   "setup_s"}
    for name in ("10x-atcc.bin", "10x-atcc.deep"):
        assert {m["name"] for m in harness.load_cell(ROOT, name).end_to_end
                } == {"reads_per_s", "setup_s"}


def test_each_raw_twin_is_its_base_moving_the_peak_memory():
    """``<metric>.raw`` is ``<metric>`` in the cells that report
    ``memory_peak_gb``: the same entry but for its name, what it moves
    and its cells, and a reader that reads what the base's reads."""
    ms = {m["name"]: m for m in _manifest()["per_layer"]}
    twins = [n for n in ms if n.endswith(".raw")]
    assert len(twins) == 14
    for name in twins:
        base = name[:-len(".raw")]
        want = {"name": name, "moves": "memory_peak_gb",
                "workloads": ["stlfr-atcc.raw"]}
        if base == "reads_per_s":
            e2e = {m["name"]: m for m in _manifest()["end_to_end"]}[base]
            assert (ms[name]["unit"], ms[name]["better"]) == (
                e2e["unit"], e2e["better"])
            continue
        assert ms[name] == dict(ms[base], **want), name
        assert "stlfr-atcc.raw" not in ms[base]["workloads"], base
