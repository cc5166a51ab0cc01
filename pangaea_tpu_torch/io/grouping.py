"""Barcode-group streaming with reference-exact flush semantics.

Copied from pangaea_tpu.io.grouping. The reference groups a
barcode-sorted read stream into per-barcode concatenated strings inside
count_kmer/count_tnf. Its grouping has a quirk we must reproduce for
byte-identical features (count_kmer.cpp:199-219 paired / :246-270
interleaved):

    reads_seq += pair            # pair appended FIRST
    if barcode != last_barcode:  # ... then the change check
        flush(last_barcode, reads_seq); last_barcode = barcode; clear

so the *first pair of each new barcode* leaks into the *previous*
barcode's group, and the very first flushed group carries the empty
last_barcode (dropped later because empty barcodes are skipped,
count_kmer.cpp:62). A final flush emits the trailing group.

Group-level filters applied downstream (count_kmer.cpp:62-63): barcode
empty, or concatenated length <= min_len where the concatenated string is
``seq1 + 'N' + seq2 + 'N'`` per pair, i.e. sum(len(s) + 1).

In paired (-1/-2) mode only, pairs whose R1/R2 name or barcode disagree
are dropped entirely before grouping (count_kmer.cpp:195-197).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Tuple

from pangaea_tpu_torch.io.fastq import (BarcodeParser, iter_interleaved_pairs,
                                        iter_paired_pairs)


@dataclass
class ReadPair:
    name: str
    barcode: str
    seq1: str
    seq2: str
    qual1: str = ""
    qual2: str = ""
    # paired (-1/-2) mode: R1/R2 name or barcode disagreed. The reference
    # skips such pairs from GROUPING entirely (count_kmer.cpp:195-197)
    # without touching last_barcode, but jellyfish still counts their
    # bases (it reads the raw files) — so the sort-join path must keep
    # them in the stream as global-only (seg -1) reads.
    mismatched: bool = False


def iter_read_pairs_interleaved(path: str) -> Iterator[ReadPair]:
    parser = BarcodeParser()
    for r1, r2 in iter_interleaved_pairs(path):
        name, barcode = parser.parse(r1.header)
        yield ReadPair(name, barcode, r1.seq, r2.seq, r1.qual, r2.qual)


def iter_read_pairs_paired(path1: str, path2: str,
                           drop_unpaired: bool = True) -> Iterator[ReadPair]:
    """drop_unpaired=True reproduces count_kmer.cpp:195-197 (mismatched
    pairs vanish); False yields them flagged ``mismatched`` so grouping
    can route them as global-only reads (jellyfish parity)."""
    parser = BarcodeParser()
    for r1, r2 in iter_paired_pairs(path1, path2):
        n1, b1 = parser.parse(r1.header)
        n2, b2 = parser.parse(r2.header)
        if n1 != n2 or b1 != b2:
            if drop_unpaired:
                continue  # count_kmer.cpp:195-197
            yield ReadPair(n1, b1, r1.seq, r2.seq, r1.qual, r2.qual,
                           mismatched=True)
            continue
        yield ReadPair(n1, b1, r1.seq, r2.seq, r1.qual, r2.qual)


def iter_barcode_groups(pairs: Iterable[ReadPair],
                        bug_compat: bool = True
                        ) -> Iterator[Tuple[str, List[ReadPair]]]:
    """Group a (barcode-sorted) pair stream; yields (barcode, pairs).

    With bug_compat=True (default), replicates the reference's
    boundary-leak flush order described in the module docstring, including
    the leading empty-barcode group and the trailing flush. With
    bug_compat=False, does clean exact grouping.

    Mismatched pairs never touch the grouping state: they are emitted in
    ""-barcode groups of up to 512 pairs, which the group filter drops
    (with keep_dropped their reads stay in the stream as seg -1 rows).
    """
    side: List[ReadPair] = []
    acc: List[ReadPair] = []
    last_barcode = "" if bug_compat else None
    for p in pairs:
        if p.mismatched:
            side.append(p)
            if len(side) >= 512:
                yield "", side
                side = []
            continue
        if bug_compat:
            acc.append(p)
            if p.barcode != last_barcode:
                yield last_barcode, acc
                last_barcode = p.barcode
                acc = []
            continue
        if last_barcode is None:
            last_barcode = p.barcode
        if p.barcode != last_barcode:
            yield last_barcode, acc
            last_barcode = p.barcode
            acc = []
        acc.append(p)
    if side:
        yield "", side
    if last_barcode is not None:
        yield last_barcode, acc  # final flush (count_kmer.cpp:280)


def group_concat_length(group: List[ReadPair]) -> int:
    """len of the reference's concatenated string: seq+'N' per read
    (count_kmer.cpp:199,247-249)."""
    return sum(len(p.seq1) + 1 + len(p.seq2) + 1 for p in group)


def group_kept(barcode: str, group: List[ReadPair], min_len: int) -> bool:
    """count_kmer.cpp:62-63: skip if barcode empty or concat len <= min_len."""
    return bool(barcode) and group_concat_length(group) > min_len
