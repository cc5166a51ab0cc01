"""Auto-k via community diversity (reference: src/scripts/
calculate_diversity.sh + calculate_diversity.R + metaphlan_tables.py).

Copied from pangaea_tpu.asm.diversity with the imports renamed.

Contract: metaphlan4 profiles the reads (calculate_diversity.sh:59); the
species-level relative abundances feed a Shannon alpha-diversity
computation (the reference does this in R via microbiome::diversity,
calculate_diversity.R); the pipeline then uses k = int(8 * shannon)
(src/clustering.py:100-101).

The R stage is replaced with the direct computation: Shannon
H = -sum(p_i * ln(p_i)) over the normalized species abundances.
"""

from __future__ import annotations

import logging
import math
import os
import re
from typing import List

from pangaea_tpu_torch.asm.tools import ToolRunner

log = logging.getLogger(__name__)


def shannon_from_profile(profile_path: str,
                         taxon_separator: str = "t__") -> float:
    """Shannon diversity of one metaphlan profile, replicating the R
    stage's semantics (calculate_diversity.R invoked by
    calculate_diversity.sh:64 WITHOUT ``-s``, so the separator defaults
    to ``t__`` — SGB-level rows, calculate_diversity.R:49-50,119):

    - keep rows whose clade path CONTAINS the separator (R ``grep``,
      :119-121);
    - microbiome::alpha diversity_shannon: drop zeros, p = x/sum(x),
      H = -sum(p ln p) (the table's /100 rescale at :157 cancels);
    - the ``mat[2,1]`` second-sample pick (:262) reads the duplicated
      column of the profile merged with itself
      (calculate_diversity.sh:62) — identical to this single pass.

    Falls back to ``s__`` rows when the profile has no ``t__`` rows
    (metaphlan3-style profiles — outside the reference contract, but
    strictly better than returning 0).
    """
    def collect(sep: str) -> List[float]:
        out: List[float] = []
        with open(profile_path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3 or sep not in parts[0]:
                    continue
                try:
                    out.append(float(parts[2]))
                except ValueError:
                    continue
        return out

    abunds = collect(taxon_separator)
    if not abunds and taxon_separator == "t__":
        abunds = collect("s__")
    total = sum(a for a in abunds if a > 0)
    if total <= 0:
        return 0.0
    h = 0.0
    for a in abunds:
        if a > 0:
            p = a / total
            h -= p * math.log(p)
    return h


def find_latest_mpa_index(db_dir: str) -> str:
    """Latest ``mpa_v*.1.bt2l`` index prefix (calculate_diversity.sh:13-37)."""
    candidates = []
    for name in os.listdir(db_dir):
        if re.match(r"^mpa_v[^ ]+\.1\.bt2l$", name) and ".rev." not in name:
            candidates.append(name[: -len(".1.bt2l")])
    if not candidates:
        raise FileNotFoundError(
            f"No valid MetaPhlAn database index found in '{db_dir}'")
    return sorted(candidates)[-1]


def merge_metaphlan_tables(profiles: List[str], out_path: str) -> None:
    """Table join of metaphlan profiles (src/scripts/metaphlan_tables.py:
    clade x sample relative-abundance matrix, missing clades -> 0)."""
    columns = []  # (sample_name, {clade: abund})
    version = None
    for path in profiles:
        hdr = []
        with open(path) as f:
            for line in f:
                if not line.startswith("#"):
                    break
                hdr.append(line.strip())
        if hdr and version is None:
            version = hdr[0]
        data = {}
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 3:
                    data[parts[0]] = parts[2]
        sample = os.path.splitext(os.path.basename(path))[0].replace(
            "_profile", "")
        columns.append((sample, data))
    clades = sorted({c for _, d in columns for c in d})
    with open(out_path, "w") as out:
        if version:
            out.write(version + "\n")
        out.write("clade_name\t" + "\t".join(s for s, _ in columns) + "\n")
        for clade in clades:
            out.write(clade + "\t" + "\t".join(
                d.get(clade, "0") for _, d in columns) + "\n")


def metaphlan_shannon(reads: str, db_path: str, workdir: str,
                      threads: int = 8) -> float:
    """Run metaphlan (offline, latest index — calculate_diversity.sh:59)
    and return the Shannon diversity; writes the reference's
    ``metaphlan_tmp/diversity_analysis/profiles_table_shannon.txt``
    layout (src/clustering.py:100). The R microbiome::diversity stage is
    replaced by the direct computation."""
    runner = ToolRunner(log_dir=workdir)
    runner.require("metaphlan")
    tmp = os.path.join(workdir, "metaphlan_tmp")
    div_dir = os.path.join(tmp, "diversity_analysis")
    os.makedirs(div_dir, exist_ok=True)
    profile = os.path.join(tmp, "profiled.txt")
    bt2 = os.path.join(tmp, "metagenome_from_reads.bowtie2.bz2")
    if not os.path.isfile(profile):
        index = find_latest_mpa_index(db_path)
        runner.run(["metaphlan", reads, "--offline", "--index", index,
                    "--input_type", "fastq", "--bowtie2db", db_path,
                    "--bowtie2out", bt2, "--nproc", str(threads),
                    "-o", profile], log_name="metaphlan.log")
    merge_metaphlan_tables([profile, profile],
                           os.path.join(tmp, "profiles_table.tsv"))
    h = shannon_from_profile(profile)
    with open(os.path.join(div_dir, "profiles_table_shannon.txt"), "w") as f:
        f.write(f"{h}\n")
    return h


# ---- the rest of calculate_diversity.R's metric surface -------------------
#
# The pipeline itself only ever invokes alpha/shannon
# (calculate_diversity.sh:64), but the reference ships the full script
# surface (calculate_diversity.R:38-263); these are formula-level ports
# of every metric, including the unifrac pair (which needs the `-t`
# phylogeny the pipeline itself never supplies — see `unifrac` below).
# All functions take per-taxon abundance vectors/columns AFTER the
# separator row filter (see shannon_from_profile) — the /100 rescale
# cancels everywhere except clr, where it shifts every component
# equally and cancels in the aitchison distance.

def alpha_diversity(abunds, metric: str = "shannon") -> float:
    """microbiome::alpha on one sample column (calculate_diversity.R:
    238-259): richness (observed taxa), shannon (H, natural log),
    simpson (Gini-Simpson 1 - sum p^2), gini (dominance: the Gini
    inequality coefficient of the abundance distribution)."""
    xs = [a for a in abunds if a > 0]
    if not xs:
        return 0.0
    total = sum(xs)
    if metric == "richness":
        return float(len(xs))
    if metric == "shannon":
        return -sum((a / total) * math.log(a / total) for a in xs)
    if metric == "simpson":
        return 1.0 - sum((a / total) ** 2 for a in xs)
    if metric == "gini":
        s = sorted(xs)
        n = len(s)
        return (2.0 * sum((i + 1) * v for i, v in enumerate(s))
                / (n * total)) - (n + 1.0) / n
    raise ValueError(f"unknown alpha metric '{metric}'")


def beta_diversity(col_a, col_b, metric: str = "bray-curtis") -> float:
    """rbiom::beta.div between two sample columns over the same taxon
    rows (calculate_diversity.R:161-236): bray-curtis (weighted),
    jaccard (unweighted presence/absence), aitchison (euclidean over
    clr-transformed columns). The tree-backed unifrac pair lives in
    `unifrac` (it additionally needs the phylogeny and row names)."""
    if metric == "bray-curtis":
        num = sum(abs(a - b) for a, b in zip(col_a, col_b))
        den = sum(a + b for a, b in zip(col_a, col_b))
        return num / den if den else 0.0
    if metric == "jaccard":
        both = sum(1 for a, b in zip(col_a, col_b) if a > 0 and b > 0)
        either = sum(1 for a, b in zip(col_a, col_b) if a > 0 or b > 0)
        return 1.0 - both / either if either else 0.0
    if metric == "aitchison":
        ca, cb = clr_transform(col_a), clr_transform(col_b)
        return math.sqrt(sum((a - b) ** 2 for a, b in zip(ca, cb)))
    raise ValueError(f"unknown beta metric '{metric}'")


# ---- unifrac (calculate_diversity.R:173-222) ------------------------------
#
# The R script reads the MetaPhlAn species tree with ape::read.tree,
# drops profile species absent from the tree (logged), prunes the tree
# to the surviving species with ape::keep.tip, and hands the pruned
# tree + filtered table to rbiom::beta.div(method="unifrac"). The port
# below replicates each stage:
#   * `NewickNode`/`read_newick`  — ape::read.tree's data (topology,
#     tip labels, branch lengths; unresolved lengths -> None).
#   * `keep_tip`                  — ape::keep.tip semantics: prune to
#     the kept tips' induced subtree rooted at their MRCA, collapsing
#     single-child chains by SUMMING branch lengths and DISCARDING any
#     edge above the MRCA (collapse.singles root.edge=FALSE default).
#   * `unifrac`                   — rbiom::beta.div unifrac: per edge b
#     with length L_b and tip-descendant abundance fraction p(b) =
#     (sum of the sample's abundance under b) / (sample total),
#     weighted   d = sum_b L_b * |p_A(b) - p_B(b)|   (non-normalized),
#     unweighted d = sum_{b: presence differs} L_b
#                    / sum_{b: present in either} L_b.
# keep_tip is value-relevant for UNWEIGHTED unifrac: edges above the
# MRCA (present in both samples by construction) would otherwise
# inflate the shared-branch denominator.


class NewickNode:
    """One node of an ape-style rooted tree (tips carry names)."""

    __slots__ = ("name", "length", "children")

    def __init__(self, name: str = "", length=None, children=None):
        self.name = name
        self.length = length
        self.children = children or []

    def tip_labels(self) -> List[str]:
        # iterative: MetaPhlAn species trees have ladder regions deeper
        # than Python's recursion limit
        out: List[str] = []
        stack = [self]
        while stack:
            node = stack.pop()
            if not node.children:
                out.append(node.name)
            else:
                stack.extend(reversed(node.children))
        return out


def read_newick(text: str) -> NewickNode:
    """Parse one Newick tree (ape::read.tree on the MetaPhlAn species
    tree, calculate_diversity.R:175). Supports nested clades, tip and
    internal labels, branch lengths, and quoted labels; returns the
    root. Raises ValueError on malformed input. Iterative (explicit
    stack): real species trees nest deeper than the recursion limit."""
    s = text.strip()
    if s.endswith(";"):
        s = s[:-1]
    n = len(s)
    pos = 0

    def parse_label() -> str:
        nonlocal pos
        if pos < n and s[pos] == "'":
            end = s.index("'", pos + 1)
            label = s[pos + 1:end]
            pos = end + 1
            return label
        start = pos
        while pos < n and s[pos] not in "(),:;":
            pos += 1
        return s[start:pos].strip()

    def parse_suffix(node: NewickNode) -> None:
        nonlocal pos
        node.name = parse_label()
        if pos < n and s[pos] == ":":
            pos += 1
            node.length = float(parse_label())

    root = NewickNode()
    stack: List[NewickNode] = []  # open internal nodes
    cur = root
    while True:
        if pos < n and s[pos] == "(":
            pos += 1
            stack.append(cur)
            child = NewickNode()
            cur.children.append(child)
            cur = child
            continue
        parse_suffix(cur)
        if pos >= n:
            break
        ch = s[pos]
        if ch == ",":
            pos += 1
            if not stack:
                raise ValueError(f"',' outside parentheses at {pos}")
            cur = NewickNode()
            stack[-1].children.append(cur)
        elif ch == ")":
            pos += 1
            if not stack:
                raise ValueError(f"unbalanced ')' at {pos}")
            cur = stack.pop()
        else:
            raise ValueError(f"unexpected '{ch}' at {pos}")
    if stack:
        raise ValueError("unbalanced parentheses in newick")
    return root


def keep_tip(root: NewickNode, keep) -> NewickNode:
    """ape::keep.tip(tree, tips) (calculate_diversity.R:191): the
    subtree induced on `keep`, rooted at those tips' MRCA. Single-child
    chains collapse with branch lengths summed (collapse.singles); the
    edge above the MRCA is discarded (root.edge=FALSE default), so the
    returned root has length None. Raises ValueError if < 2 kept tips
    (ape errors on < 2 as well)."""
    keep = set(keep)
    # iterative post-order (explicit stack; see read_newick on depth)
    out = {}
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if not node.children:
            out[id(node)] = (NewickNode(node.name, node.length)
                             if node.name in keep else None)
            continue
        if not expanded:
            stack.append((node, True))
            stack.extend((c, False) for c in node.children)
            continue
        kept = [p for p in (out[id(c)] for c in node.children) if p]
        if not kept:
            out[id(node)] = None
        elif len(kept) == 1:
            child = kept[0]
            if node.length is not None:
                child.length = (child.length or 0.0) + node.length
            out[id(node)] = child
        else:
            out[id(node)] = NewickNode(node.name, node.length, kept)

    pruned = out[id(root)]
    if pruned is None or not pruned.children:
        raise ValueError("keep.tip: fewer than 2 tips retained")
    pruned.length = None
    return pruned


def unifrac(rows: List[str], col_a, col_b, tree: NewickNode,
            weighted: bool) -> float:
    """rbiom::beta.div(..., tree, method="unifrac", weighted=...)
    between two sample columns (calculate_diversity.R:215-220),
    including the R script's preceding filters: species absent from the
    tree are dropped from the table (:181-192, the *_species.log set)
    and the tree is pruned to the survivors via `keep_tip`. Sample
    totals are the COLUMN SUMS OF THE FILTERED TABLE (rbiom normalizes
    within the table it is handed). A sample whose filtered column sums
    to zero is removed by the R script before the distance (:195-213);
    here that is surfaced as a ValueError since a pairwise distance
    with a removed sample does not exist. Edges with no length in the
    newick count as length 0."""
    tips = set(tree.tip_labels())
    kept_idx = [i for i, r in enumerate(rows) if r in tips]
    if not kept_idx:
        raise ValueError("unifrac: no profile species present in the tree")
    table = {rows[i]: (float(col_a[i]), float(col_b[i])) for i in kept_idx}
    pruned = keep_tip(tree, [rows[i] for i in kept_idx])
    tot_a = sum(a for a, _ in table.values())
    tot_b = sum(b for _, b in table.values())
    if tot_a == 0 or tot_b == 0:
        raise ValueError(
            "unifrac: a sample has zero abundance over the tree species "
            "(the R script removes such samples before the distance)")

    diff = union = dist = 0.0
    # iterative post-order (see read_newick on depth)
    sums = {}
    stack = [(pruned, False)]
    while stack:
        node, expanded = stack.pop()
        if node.children and not expanded:
            stack.append((node, True))
            stack.extend((c, False) for c in node.children)
            continue
        if not node.children:
            a, b = table[node.name]
        else:
            a = b = 0.0
            for c in node.children:
                ca, cb = sums.pop(id(c))
                a += ca
                b += cb
        sums[id(node)] = (a, b)
        if node is not pruned:
            length = node.length or 0.0
            dist += length * abs(a / tot_a - b / tot_b)
            if (a > 0) != (b > 0):
                diff += length
            if a > 0 or b > 0:
                union += length
    if weighted:
        return dist
    return diff / union if union else 0.0


def clr_transform(col) -> List[float]:
    """compositions::clr (calculate_diversity.R:227-230): log(x) minus
    the mean log over ALL components. A zero component makes the mean
    -inf and the output inf/nan — exactly what the R package does on an
    unzero-replaced table (the reference does not zero-replace)."""
    logs = [math.log(a) if a > 0 else float("-inf") for a in col]
    m = sum(logs) / len(logs)
    return [v - m for v in logs]
