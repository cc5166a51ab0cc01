"""PyTorch port vs pangaea_tpu: asm/diversity.py, the metaphlan Shannon
estimate of the cluster count and the rest of the reference's diversity
metrics, on the fixtures of tests/test_diversity_r_parity.py,
tests/test_misc.py and tests/test_asm.py. The module is a host copy, so
every value must be equal, float for float, and every file byte for
byte."""

import math
import os
import stat

import numpy as np
import pytest

from pangaea_tpu.asm import diversity as jdiv
from pangaea_tpu_torch.asm import diversity as tdiv
from pangaea_tpu_torch.asm.tools import ToolMissingError, ToolRunner
from tests.test_diversity_r_parity import MPA4_PROFILE, write_profile

MISC_PROFILE = [("k__Bacteria", "2", "100.0"),
                ("k__Bacteria|s__Ecoli", "2|561", "60.0"),
                ("k__Bacteria|s__Bsub", "2|1423", "40.0")]


def _random_profile(seed):
    rng = np.random.RandomState(seed)
    rows = [("k__Bacteria", "2", "100.0")]
    for i in range(rng.randint(1, 12)):
        rows.append((f"k__Bacteria|p__P|c__C|o__O|f__F|g__G|s__S{i}|"
                     f"t__SGB{i}", "2|", str(round(float(rng.rand() * 40),
                                                   5))))
    return rows


PROFILES = {
    "mpa4": MPA4_PROFILE,
    "zero_row": MPA4_PROFILE + [
        ("k__Bacteria|p__X|c__Y|o__Z|f__W|g__V|s__U|t__SGB999", "2|",
         "0.0")],
    "mpa3": [r for r in MPA4_PROFILE if "t__" not in r[0]],
    "species_only": MISC_PROFILE,
    "random3": _random_profile(3),
    "random4": _random_profile(4),
    "empty": [("k__Bacteria", "2", "100.0")],
}


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("sep", ["t__", "s__"])
def test_shannon_from_profile_matches_jax(name, sep, tmp_path):
    path = str(tmp_path / "profiled.txt")
    write_profile(path, PROFILES[name])
    assert (tdiv.shannon_from_profile(path, sep)
            == jdiv.shannon_from_profile(path, sep))


@pytest.mark.parametrize("pair", [("mpa4", "mpa4"), ("species_only", "mpa4"),
                                  ("random3", "empty")])
def test_merge_metaphlan_tables_matches_jax(pair, tmp_path):
    paths = []
    for i, name in enumerate(pair):
        paths.append(str(tmp_path / f"{name}{i}_profile.txt"))
        write_profile(paths[-1], PROFILES[name])
    outs = []
    for mod in (tdiv, jdiv):
        out = str(tmp_path / f"{mod.__name__}.tsv")
        mod.merge_metaphlan_tables(paths, out)
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("names", [
    ["mpa_vJan21_X.1.bt2l", "mpa_vOct22_Y.1.bt2l", "mpa_vOct22_Y.rev.1.bt2l",
     "junk.txt"],
    ["junk.txt"],
])
def test_find_latest_mpa_index_matches_jax(names, tmp_path):
    for name in names:
        open(tmp_path / name, "w").close()
    results = []
    for mod in (tdiv, jdiv):
        try:
            results.append(mod.find_latest_mpa_index(str(tmp_path)))
        except FileNotFoundError as e:
            results.append(type(e))
    assert results[0] == results[1]


def _columns(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(3, 12)
    a = rng.rand(n) * 20
    b = rng.rand(n) * 20
    a[rng.rand(n) < 0.2] = 0.0
    return list(a), list(b)


def _same(x, y):
    assert x == y or (math.isnan(x) and math.isnan(y))


@pytest.mark.parametrize("metric", ["richness", "shannon", "simpson", "gini",
                                    "nope"])
def test_alpha_diversity_matches_jax(metric):
    for seed in range(10):
        a, _ = _columns(seed)
        if metric == "nope":
            for mod in (tdiv, jdiv):
                with pytest.raises(ValueError):
                    mod.alpha_diversity(a, metric)
            return
        _same(tdiv.alpha_diversity(a, metric), jdiv.alpha_diversity(a, metric))
    assert tdiv.alpha_diversity([0.0], metric) == 0.0


@pytest.mark.parametrize("metric", ["bray-curtis", "jaccard", "aitchison"])
def test_beta_diversity_matches_jax(metric):
    for seed in range(10):
        a, b = _columns(seed)
        _same(tdiv.beta_diversity(a, b, metric),
              jdiv.beta_diversity(a, b, metric))
    for mod in (tdiv, jdiv):
        with pytest.raises(ValueError):
            mod.beta_diversity([1.0], [1.0], "nope")


@pytest.mark.parametrize("col", [[1.0, 0.0, 2.0], [3.0, 5.0, 7.0, 0.5]])
def test_clr_transform_matches_jax(col):
    for x, y in zip(tdiv.clr_transform(col), jdiv.clr_transform(col)):
        _same(x, y)


def _ladder(depth):
    text = "(T0:1,T1:1)"
    for i in range(2, depth):
        text = f"({text}:1,T{i}:1)"
    return text + ";"


def _random_tree(seed):
    rng = np.random.RandomState(seed)

    def sub(labels):
        if len(labels) == 1:
            return f"{labels[0]}:{rng.rand() * 4 + 0.05:.4f}"
        k = rng.randint(1, len(labels))
        return f"({sub(labels[:k])},{sub(labels[k:])}):{rng.rand() * 4:.4f}"

    labels = [f"T{i}" for i in range(rng.randint(4, 14))]
    h = len(labels) // 2
    return "(" + sub(labels[:h]) + "," + sub(labels[h:]) + ");", labels


def _shape(node):
    """A tree as nested tuples, to compare two packages' node classes."""
    return (node.name, node.length, tuple(_shape(c) for c in node.children))


TREES = {
    "hand": ("((A:1,B:2)ab:0.5,(C:3,'D d':1):0.25)root;",
             ["A", "B", "C", "D d"]),
    "prune": ("(((A:1,E:4):2,B:2):0.5,(C:3,F:7):1);", ["A", "B", "C", "X"]),
    "random23": _random_tree(23),
    "random24": _random_tree(24),
    "ladder": (_ladder(1500), [f"T{i}" for i in range(1500)]),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_newick_keep_tip_unifrac_match_jax(name):
    text, rows = TREES[name]
    tt, jt = tdiv.read_newick(text), jdiv.read_newick(text)
    if name != "ladder":
        assert _shape(tt) == _shape(jt)
    assert tt.tip_labels() == jt.tip_labels()
    kept = [r for r in rows if r in set(jt.tip_labels())][:-1]
    if name != "ladder":
        assert (_shape(tdiv.keep_tip(tt, kept))
                == _shape(jdiv.keep_tip(jdiv.read_newick(text), kept)))
    rng = np.random.RandomState(len(rows))
    a = list(rng.rand(len(rows)) * 10 * (rng.rand(len(rows)) > 0.3))
    b = list(rng.rand(len(rows)) * 10 * (rng.rand(len(rows)) > 0.3))
    a[0], b[-2] = 1.0, 1.0   # both columns non-zero over the tree
    for weighted in (True, False):
        assert (tdiv.unifrac(rows, a, b, tdiv.read_newick(text), weighted)
                == jdiv.unifrac(rows, a, b, jdiv.read_newick(text), weighted))


@pytest.mark.parametrize("case", ["zero_sample", "no_species", "one_tip",
                                  "bad_newick"])
def test_diversity_errors_match_jax(case):
    text = "((A:1,B:2):0.5,C:3);"
    for mod in (tdiv, jdiv):
        with pytest.raises(ValueError):
            if case == "zero_sample":
                mod.unifrac(["A", "B", "C"], [0.0] * 3, [1.0] * 3,
                            mod.read_newick(text), weighted=True)
            elif case == "no_species":
                mod.unifrac(["Q", "R"], [1.0, 1.0], [1.0, 1.0],
                            mod.read_newick(text), weighted=True)
            elif case == "one_tip":
                mod.keep_tip(mod.read_newick(text), ["A"])
            else:
                mod.read_newick("((A:1,B:2;")


def _stub_metaphlan(tmp_path):
    """tests/test_asm.py's stub: checks the latest index, writes a
    60/40 metaphlan4 profile."""
    db = tmp_path / "db"
    db.mkdir()
    for f in ("mpa_vJan21_X.1.bt2l", "mpa_vOct22_SGB.1.bt2l",
              "mpa_vOct22_SGB.rev.1.bt2l"):
        (db / f).write_text("")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "metaphlan"
    stub.write_text("""#!/bin/bash
set -e
out=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2;;
    --index) [ "$2" = "mpa_vOct22_SGB" ] || exit 3; shift 2;;
    *) shift;;
  esac
done
cat > "$out" <<'PROF'
#mpa_vOct22_CHOCOPhlAnSGB_202212
#clade_name	NCBI_tax_id	relative_abundance	additional_species
k__Bacteria	2	100.0
k__Bacteria|p__F|c__C|o__O|f__F|g__G|s__A	2|1	60.0
k__Bacteria|p__F|c__C|o__O|f__F|g__G|s__A|t__SGB1	2|1|	60.0
k__Bacteria|p__F|c__C|o__O|f__F|g__G|s__B	2|2	40.0
k__Bacteria|p__F|c__C|o__O|f__F|g__G|s__B|t__SGB2	2|2|	40.0
PROF
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return str(db), str(bindir)


def test_metaphlan_shannon_with_stub_matches_jax(tmp_path, monkeypatch):
    db, bindir = _stub_metaphlan(tmp_path)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    reads = tmp_path / "reads.fq"
    reads.write_text("@r1\nACGT\n+\nIIII\n")
    hs, files = [], []
    for mod in (tdiv, jdiv):
        work = tmp_path / mod.__name__
        hs.append(mod.metaphlan_shannon(str(reads), db, str(work)))
        tmp = work / "metaphlan_tmp"
        files.append([(tmp / f).read_bytes() for f in (
            "profiled.txt", "profiles_table.tsv",
            "diversity_analysis/profiles_table_shannon.txt")])
    assert hs[0] == hs[1] and int(8 * hs[0]) == 5
    assert files[0] == files[1]


def test_metaphlan_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(ToolMissingError):
        ToolRunner().require("metaphlan")
    with pytest.raises(ToolMissingError):
        tdiv.metaphlan_shannon("r.fq", str(tmp_path), str(tmp_path / "w"))
