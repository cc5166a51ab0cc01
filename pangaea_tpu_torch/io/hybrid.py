"""Hybrid short+long mode: virtual barcodes from long-read alignments
(copied from pangaea_tpu.io.hybrid).

Contracts:

- long-read barcode map (src/run_pangaea:171-199): each long read's name
  becomes its own barcode — map lines ``<name> BX:Z:<name>``.
- add_barcode (src/cpptools/add_barcode.cpp): from the name-sorted
  short->long BAM, each short read pair collects the barcodes of every
  long read it aligns to with >= 60 M/I/D columns (mapped records whose
  contig is in the map), then draws ONE uniformly at random
  (srand(2023), :105 ``rand() % size``); output lines are
  ``<name> <barcode>`` (or bare ``<name>`` when no barcode qualified).
  The draw replicates glibc's ``rand()`` stream bit-exactly
  (utils.GlibcRand), matching the reference run single-threaded — under
  OpenMP the reference's own rand() interleaving is nondeterministic.
- assign_barcodes (src/cpptools/assign_barcodes.cpp): rewrite R1/R2 into
  one interleaved FASTQ; reads found in the map with a real barcode get
  headers ``@<name> BX:Z:<bc>-1`` (the barcode value in the map already
  carries the ``BX:Z:`` prefix), others ``@<name>``.
"""

from __future__ import annotations

import logging
from typing import Dict

from pangaea_tpu_torch.io.bam import BamReader
from pangaea_tpu_torch.io.fastq import BarcodeParser, open_maybe_gzip
from pangaea_tpu_torch.utils import GlibcRand

log = logging.getLogger(__name__)


def make_longread_barcode_map(longreads: str, out_path: str) -> int:
    """src/run_pangaea:180-199 awk: name -> BX:Z:name (fastq or fasta)."""
    n = 0
    with open_maybe_gzip(longreads) as f, open(out_path, "w") as out:
        first = f.readline()
        if not first:
            return 0

        def emit(header_line: str) -> None:
            nonlocal n
            name = header_line[1:].split()[0]
            out.write(f"{name} BX:Z:{name}\n")
            n += 1

        if first.startswith(">"):
            emit(first)
            for line in f:
                if line.startswith(">"):
                    emit(line)
        else:
            emit(first)
            while True:
                for _ in range(3):
                    f.readline()
                header = f.readline()
                if not header:
                    break
                emit(header)
    return n


def load_barcode_map(path: str) -> Dict[str, str]:
    """``<name> <barcode>`` lines (add_barcode.cpp:117-131)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            pos = line.find(" ")
            if pos == -1:
                out.setdefault(line, "")
                continue
            name, barcode = line[:pos], line[pos + 1:]
            if name in out:
                log.info("Barcode for long read %s is already in the list.",
                         name)
            else:
                out[name] = barcode
    return out


def add_barcode(bam_path: str, map_path: str, out_prefix: str,
                min_cols: int = 60, seed: int = 2023) -> str:
    """Writes <out>_map.txt; returns its path."""
    lr_to_barcode = load_barcode_map(map_path)
    rng = GlibcRand(seed)
    reader = BamReader(bam_path)
    out_path = out_prefix + "_map.txt"
    n_bc = n_nobc = 0
    with open(out_path, "w") as out:
        group_name = None
        candidates = []

        def flush():
            nonlocal n_bc, n_nobc
            if group_name is None:
                return
            if candidates:
                barcode = candidates[rng.rand() % len(candidates)]
                out.write(f"{group_name} {barcode}\n")
                n_bc += 1
            else:
                out.write(f"{group_name}\n")
                n_nobc += 1

        for rec in reader:
            if not rec.qname:
                continue
            if rec.qname != group_name:
                flush()
                group_name = rec.qname
                candidates = []
            if rec.is_unmapped:
                continue
            contig = reader.ref_name(rec.tid)
            if not contig:
                continue
            if contig not in lr_to_barcode:
                log.info("Find a long read without assigned barcode: %s",
                         contig)
                continue
            if rec.alignment_columns() < min_cols:
                continue
            candidates.append(lr_to_barcode[contig])
        flush()
    log.info("With barcode: %d; without barcode: %d", n_bc, n_nobc)
    return out_path


def assign_barcodes(map_path: str, fastq1: str, fastq2: str,
                    out_path: str) -> int:
    """Interleave R1/R2 with mapped virtual barcodes; returns pair count."""
    read_to_barcode: Dict[str, str] = {}
    with open(map_path) as f:
        for line in f:
            line = line.rstrip("\n")
            pos = line.find("BX:Z:")
            if pos == -1:
                name, barcode = line, " "
            else:
                name, barcode = line[:pos], line[pos:]
            name = name.strip()
            read_to_barcode.setdefault(name, barcode)
    parser = BarcodeParser()
    n = 0
    with open_maybe_gzip(fastq1) as f1, open_maybe_gzip(fastq2) as f2, \
            open(out_path, "w") as out:
        it1, it2 = iter(f1), iter(f2)
        for h1 in it1:
            name, _ = parser.parse(h1.rstrip("\n").lstrip("@"))
            try:
                s1, p1, q1 = [next(it1).rstrip("\n") for _ in range(3)]
                h2, s2, p2, q2 = [next(it2).rstrip("\n")
                                  for _ in range(4)]
            except StopIteration:
                # a genexp here would turn this into an opaque PEP 479
                # RuntimeError; raise the real problem instead
                raise ValueError(
                    "truncated or length-mismatched R1/R2 FASTQ during "
                    f"barcode assignment (at read {name!r})") from None
            barcode = read_to_barcode.get(name, "")
            if barcode and barcode != " ":
                hdr = f"@{name} {barcode}-1"
            else:
                hdr = f"@{name}"
            out.write(f"{hdr}\n{s1}\n+\n{q1}\n{hdr}\n{s2}\n+\n{q2}\n")
            n += 1
    return n
