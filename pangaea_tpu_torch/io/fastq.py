"""FASTQ streaming + linked-read barcode extraction (readers only).

Host-side input layer, copied from pangaea_tpu.io.fastq (the step-0
barcode sort is not ported). The barcode
parsing rules reproduce ``getBarcode`` in the reference C++ tools
(count_kmer.cpp:23-53, count_tnf.cpp:22-52, extract_reads.cpp:9-39):

- read type is inferred once, stickily, from the first header that matches:
  a header containing ``BX:Z`` => "10x" (also Tell-Seq after preprocessing);
  otherwise a header containing ``#`` => "stLFR".
- 10x: read name = header up to first whitespace; barcode = substring after
  ``BX:Z:`` up to the first ``-``.
- stLFR: read name = header before ``#``; barcode = between ``#`` and ``/``;
  barcode ``0_0_0`` means "no barcode" and becomes empty.
"""

from __future__ import annotations

import gzip
import io
import logging
from dataclasses import dataclass
from typing import Iterator, Tuple

log = logging.getLogger(__name__)


def open_maybe_gzip(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        if "t" in mode:
            return io.TextIOWrapper(gzip.open(path, mode.replace("t", "b")),
                                    encoding="ascii", newline="\n")
        return gzip.open(path, mode)
    return open(path, mode)


@dataclass
class FastqRecord:
    header: str   # without leading '@'
    seq: str
    qual: str


class BarcodeParser:
    """Sticky read-type inference + barcode extraction (count_kmer.cpp:25-53)."""

    def __init__(self, read_type: str = ""):
        self.read_type = read_type  # "", "10x", or "stLFR"

    def parse(self, header: str) -> Tuple[str, str]:
        """header is the '@'-stripped FASTQ header line.

        Returns (read_name, barcode); barcode == "" means unbarcoded.
        """
        if not self.read_type:
            if "BX:Z" in header:
                self.read_type = "10x"
            elif "#" in header:
                self.read_type = "stLFR"
        if self.read_type == "stLFR":
            pos1 = header.find("#")
            pos2 = header.find("/", pos1 + 1)
            name = header[:pos1]
            barcode = header[pos1 + 1: pos2 if pos2 != -1 else len(header)]
            if barcode == "0_0_0":
                barcode = ""
            return name, barcode
        # 10x / Tell-Seq (or not-yet-inferred): name up to whitespace
        end = len(header)
        for ch in " \r\t\n":
            p = header.find(ch)
            if p != -1 and p < end:
                end = p
        name = header[:end]
        barcode = ""
        pos1 = header.find("BX:Z")
        if pos1 != -1:
            pos2 = header.find("-", pos1 + 5)
            barcode = header[pos1 + 5: pos2 if pos2 != -1 else len(header)]
        return name, barcode


def iter_fastq_records(path_or_handle) -> Iterator[FastqRecord]:
    if not isinstance(path_or_handle, str):
        yield from _iter_records(path_or_handle)
        return
    with open_maybe_gzip(path_or_handle) as handle:
        yield from _iter_records(handle)


def _iter_records(handle) -> Iterator[FastqRecord]:
    it = iter(handle)
    for header in it:
        try:
            seq = next(it).rstrip("\n")
            next(it)  # '+'
            qual = next(it).rstrip("\n")
        except StopIteration:
            # truncated final record: drop it with a warning instead of
            # the opaque PEP 479 RuntimeError
            log.warning("truncated FASTQ record at EOF dropped (%r...)",
                        header[:40])
            return
        yield FastqRecord(header.rstrip("\n").lstrip("@"), seq, qual)


def iter_interleaved_pairs(path: str) -> Iterator[Tuple[FastqRecord, FastqRecord]]:
    """Yield (R1, R2) record pairs from an interleaved FASTQ. A trailing
    unpaired record is dropped (count_kmer's interleaved loop reads two
    records per iteration and stops when the second getline fails,
    count_kmer.cpp:246-252)."""
    it = iter_fastq_records(path)
    while True:
        try:
            r1 = next(it)
        except StopIteration:
            return
        try:
            r2 = next(it)
        except StopIteration:
            log.warning("odd record count: trailing unpaired read %r dropped",
                        r1.header[:40])
            return
        yield r1, r2


def iter_paired_pairs(path1: str, path2: str
                      ) -> Iterator[Tuple[FastqRecord, FastqRecord]]:
    """Yield (R1, R2) record pairs from two files read in lockstep; reads
    of reads1 past the end of reads2 are dropped with a warning."""
    it1, it2 = iter_fastq_records(path1), iter_fastq_records(path2)
    for r1 in it1:
        try:
            r2 = next(it2)
        except StopIteration:
            log.warning("reads2 ended before reads1; trailing reads dropped")
            return
        yield r1, r2
