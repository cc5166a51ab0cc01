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
    for name in ("reference", "compare", "gen", "flops"):
        tops = {m.split(".")[0] for m in _imports(
            os.path.join(ROOT, "benchmark", name + ".py"))}
        assert "pangaea_tpu_torch" not in tops, name


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
