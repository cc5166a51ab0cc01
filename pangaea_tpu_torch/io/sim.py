"""Deterministic synthetic linked-read generator.

Copied from pangaea_tpu.io.sim (``simulate_linked_reads`` and
``simulate_stlfr_raw``), so that tests and ``chip_smoke.py`` can make
input from a seed without importing pangaea_tpu. For the same arguments
it writes the same bytes as the original. N species genomes, barcodes assigned to species, paired reads
drawn from genome fragments — ground-truth species labels score binning
quality (ARI).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@dataclass
class SimResult:
    barcodes: List[str]            # barcode strings, sorted (emission order)
    barcode_species: Dict[str, int]
    n_pairs: int


def simulate_linked_reads(
    out_interleaved: Optional[str] = None,
    out_r1: Optional[str] = None,
    out_r2: Optional[str] = None,
    n_species: int = 5,
    genome_len: int = 50_000,
    n_barcodes: int = 300,
    pairs_per_barcode: int = 40,
    read_len: int = 150,
    insert_len: int = 400,
    error_rate: float = 0.0,
    low_qual_rate: float = 0.0,
    seed: int = 0,
    fmt: str = "10x",
    ani_siblings: int = 0,
    ani: float = 0.97,
    abundance: str = "dirichlet",
    zipf_exponent: float = 1.25,
    shared_segment_frac: float = 0.0,
    indel_rate: float = 0.0,
    read_len_sd: float = 0.0,
    barcode_error_rate: float = 0.0,
) -> SimResult:
    """Write barcode-sorted linked reads; returns ground-truth labels.

    fmt='10x' emits headers ``@<name>\\tBX:Z:<barcode>-1`` (the post-
    preprocessing format the reference pipeline consumes); fmt='stlfr'
    emits ``@<name>#<barcode>/1``.

    ``error_rate`` substitutes bases uniformly; ``low_qual_rate`` draws
    that fraction of per-base qualities below '?' and the rest at or
    above it. Errored bases always get a low quality.

    Hard-mixture knobs (default off; they consume no rng draws when off):
    ``ani_siblings`` derives the last this-many species from earlier ones
    at ``ani`` identity; ``abundance='zipf'`` draws Zipf species
    proportions; ``shared_segment_frac`` splices one shared segment into
    every genome. Realistic-read knobs (default off, no draws when off):
    ``indel_rate`` (deletions and duplication-style insertions),
    ``read_len_sd`` (per-read target lengths ~ N(read_len, sd), clipped to
    [40, read_len]) and ``barcode_error_rate`` (one substituted barcode
    base per affected pair; the stream is re-sorted by emitted barcode).
    """
    rng = np.random.default_rng(seed)
    genomes = []
    n_base = n_species - ani_siblings
    for _ in range(n_base):
        probs = rng.dirichlet(np.full(4, 1.5))
        genomes.append("".join("ACGT"[b] for b in
                               rng.choice(4, genome_len, p=probs)))
    for i in range(ani_siblings):
        parent = np.frombuffer(genomes[i % n_base].encode(), np.uint8)
        child = parent.copy()
        mut = rng.random(len(child)) < (1.0 - ani)
        child[mut] = _BASES[
            (np.searchsorted(_BASES, child[mut])
             + rng.integers(1, 4, int(mut.sum()))) % 4]
        genomes.append(child.tobytes().decode())
    if shared_segment_frac > 0:
        seg_len = max(1, int(genome_len * shared_segment_frac))
        probs = rng.dirichlet(np.full(4, 1.5))
        seg = "".join("ACGT"[b] for b in rng.choice(4, seg_len, p=probs))
        for i in range(n_species):
            pos = int(rng.integers(0, genome_len - seg_len))
            genomes[i] = (genomes[i][:pos] + seg
                          + genomes[i][pos + seg_len:])

    # distinct fixed-width ACGT barcodes, emitted in sorted order so the
    # stream is barcode-sorted like the reference's step-0 output.
    raw = rng.integers(0, 4, size=(n_barcodes, 16))
    bcs = sorted({"".join("ACGT"[b] for b in row) for row in raw})
    while len(bcs) < n_barcodes:
        extra = "".join("ACGT"[b] for b in rng.integers(0, 4, 16))
        if extra not in bcs:
            bcs.append(extra)
    bcs = sorted(bcs[:n_barcodes])

    # skewed species proportions => distinct coverages per species
    if abundance == "zipf":
        ranks = rng.permutation(n_species) + 1.0
        props = ranks ** (-zipf_exponent)
        props /= props.sum()
    else:
        props = rng.dirichlet(np.full(n_species, 2.0))
    barcode_species = {bc: int(rng.choice(n_species, p=props)) for bc in bcs}

    def mutate(s: str) -> Tuple[str, str]:
        """(sequence, quality). Errored positions get low quality."""
        n = len(s)
        if error_rate <= 0 and low_qual_rate <= 0:
            return s, "I" * n
        errs = (rng.random(n) < error_rate if error_rate > 0
                else np.zeros(n, bool))
        chars = np.frombuffer(s.encode(), np.uint8).copy()
        if errs.any():
            chars[errs] = _BASES[rng.integers(0, 4, int(errs.sum()))]
        low = errs | (rng.random(n) < low_qual_rate)
        qual = np.where(low,
                        rng.integers(33, 63, n),   # below '?' (63)
                        rng.integers(63, 75, n)).astype(np.uint8)
        return chars.tobytes().decode(), qual.tobytes().decode()

    def take_read(template: str, want: int) -> str:
        if read_len_sd > 0:
            want = int(np.clip(rng.normal(want, read_len_sd), 40, want))
        if indel_rate <= 0:
            return template[:want]
        chars = np.frombuffer(template.encode(), np.uint8)
        n = chars.shape[0]
        dels = rng.random(n) < indel_rate / 2
        ins = rng.random(n) < indel_rate / 2
        rep = (~dels).astype(np.int8) + ins.astype(np.int8)
        return np.repeat(chars, rep)[:want].tobytes().decode()

    def emit_barcode(bc: str) -> str:
        if barcode_error_rate <= 0 or rng.random() >= barcode_error_rate:
            return bc
        pos = int(rng.integers(0, len(bc)))
        old = bc[pos]
        new = "ACGT"[("ACGT".index(old) + int(rng.integers(1, 4))) % 4]
        return bc[:pos] + new + bc[pos + 1:]

    def opener(path):
        return (gzip.open(path, "wt") if path.endswith(".gz")
                else open(path, "w"))

    fi = opener(out_interleaved) if out_interleaved else None
    f1 = opener(out_r1) if out_r1 else None
    f2 = opener(out_r2) if out_r2 else None

    slack = 0
    if indel_rate > 0:
        slack = min(max(16, int(read_len * indel_rate * 2) + 8),
                    max(0, insert_len - read_len))
    buffered = [] if barcode_error_rate > 0 else None

    n_pairs = 0
    try:
        for bc in bcs:
            g = genomes[barcode_species[bc]]
            for p in range(pairs_per_barcode):
                pos = int(rng.integers(0, len(g) - insert_len))
                frag = g[pos:pos + insert_len]
                r1, q1 = mutate(take_read(frag[:read_len + slack],
                                          read_len))
                r2, q2 = mutate(take_read(
                    _revcomp(frag[-(read_len + slack):]), read_len))
                name = f"read_{bc}_{p}"
                ebc = emit_barcode(bc)
                if fmt == "10x":
                    h1 = f"@{name}\tBX:Z:{ebc}-1"
                    h2 = h1
                else:
                    h1 = f"@{name}#{ebc}/1"
                    h2 = f"@{name}#{ebc}/2"
                b1 = f"{h1}\n{r1}\n+\n{q1}\n"
                b2 = f"{h2}\n{r2}\n+\n{q2}\n"
                if buffered is not None:
                    buffered.append((ebc, b1, b2))
                else:
                    if fi:
                        fi.write(b1 + b2)
                    if f1:
                        f1.write(b1)
                    if f2:
                        f2.write(b2)
                n_pairs += 1
        if buffered is not None:
            buffered.sort(key=lambda t: t[0])
            for _, b1, b2 in buffered:
                if fi:
                    fi.write(b1 + b2)
                if f1:
                    f1.write(b1)
                if f2:
                    f2.write(b2)
    finally:
        for f in (fi, f1, f2):
            if f:
                f.close()
    return SimResult(bcs, barcode_species, n_pairs)


@dataclass
class StlfrSimResult:
    whitelist: List[str]            # whitelist barcode strings, in order
    partitions: List[Tuple[int, int, int]]  # 1-based index triple per partition
    partition_species: List[int]
    virtual_species: Dict[str, int]  # translated barcode -> species
    n_pairs: int
    n_unassigned: int
    n_index_errors: int


def simulate_stlfr_raw(
    out_r1: str,
    out_r2: str,
    whitelist_path: str,
    n_species: int = 4,
    genome_len: int = 30_000,
    n_partitions: int = 200,
    pairs_per_partition: int = 20,
    read_len: int = 100,
    insert_len: int = 300,
    n_wl: int = 96,
    wl_len: int = 10,
    unassigned_frac: float = 0.02,
    index_error_rate: float = 0.0,
    error_rate: float = 0.0,
    seed: int = 0,
) -> StlfrSimResult:
    """RAW stLFR paired reads + whitelist, for the preprocess_stlfr
    whitelist-translation exercise (preprocess_stlfr.cpp:76-103).

    Headers are ``@<name>#<i1>_<i2>_<i3>/1`` with 1-based whitelist
    indices; preprocessing translates the triple to the concatenation of
    the three whitelist barcodes. Realism knobs:

    - partitions draw triples at random, so with enough partitions two
      PHYSICAL partitions share a virtual barcode (birthday collision —
      real stLFR merges those fragment sets);
    - ``unassigned_frac`` of pairs carry ``0_0_0`` (no barcode call;
      the reference drops the BX tag for those, :90-99);
    - ``index_error_rate`` of pairs get ONE index re-drawn (a barcode
      segment mis-called then "corrected" to the wrong whitelist entry)
      — reads leak into another, possibly novel, virtual barcode.

    ``virtual_species`` maps each intended translated barcode to its
    species (collisions resolved first-writer, mirroring how truth is
    scored); error-leaked reads are noise by design.
    """
    rng = np.random.default_rng(seed)
    genomes = []
    for _ in range(n_species):
        probs = rng.dirichlet(np.full(4, 1.5))
        genomes.append("".join("ACGT"[b] for b in
                               rng.choice(4, genome_len, p=probs)))
    # whitelist: distinct fixed-width barcodes, written one per line
    # (the reference keeps text up to the first tab,
    # preprocess_stlfr.cpp:35-37 — exercise that with a 2nd column)
    wl = []
    while len(wl) < n_wl:
        cand = "".join("ACGT"[b] for b in rng.integers(0, 4, wl_len))
        if cand not in wl:
            wl.append(cand)
    with open(whitelist_path, "w") as f:
        for i, b in enumerate(wl):
            f.write(f"{b}\t{i + 1}\n")

    partitions = [tuple(int(x) + 1 for x in rng.integers(0, n_wl, 3))
                  for _ in range(n_partitions)]
    part_species = [int(rng.integers(0, n_species))
                    for _ in range(n_partitions)]
    virtual_species: Dict[str, int] = {}
    for tri, sp in zip(partitions, part_species):
        vb = wl[tri[0] - 1] + wl[tri[1] - 1] + wl[tri[2] - 1]
        virtual_species.setdefault(vb, sp)

    def mutate(s: str) -> str:
        if error_rate <= 0:
            return s
        chars = np.frombuffer(s.encode(), np.uint8).copy()
        errs = rng.random(len(s)) < error_rate
        if errs.any():
            chars[errs] = _BASES[rng.integers(0, 4, int(errs.sum()))]
        return chars.tobytes().decode()

    n_pairs = n_unassigned = n_index_errors = 0
    with open(out_r1, "w") as f1, open(out_r2, "w") as f2:
        for pid, (tri, sp) in enumerate(zip(partitions, part_species)):
            g = genomes[sp]
            for p in range(pairs_per_partition):
                pos = int(rng.integers(0, genome_len - insert_len))
                frag = g[pos:pos + insert_len]
                r1 = mutate(frag[:read_len])
                r2 = mutate(_revcomp(frag[-read_len:]))
                emit = tri
                if unassigned_frac > 0 and rng.random() < unassigned_frac:
                    emit = (0, 0, 0)
                    n_unassigned += 1
                elif index_error_rate > 0 and \
                        rng.random() < index_error_rate:
                    which = int(rng.integers(0, 3))
                    emit = list(tri)
                    emit[which] = int(rng.integers(1, n_wl + 1))
                    emit = tuple(emit)
                    n_index_errors += emit != tri
                bc = f"{emit[0]}_{emit[1]}_{emit[2]}"
                name = f"sr_{pid}_{p}"
                q = "I" * read_len
                f1.write(f"@{name}#{bc}/1\n{r1}\n+\n{q}\n")
                f2.write(f"@{name}#{bc}/2\n{r2}\n+\n{q}\n")
                n_pairs += 1
    return StlfrSimResult(wl, partitions, part_species, virtual_species,
                          n_pairs, n_unassigned, n_index_errors)
