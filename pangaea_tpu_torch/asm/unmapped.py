"""Low-abundance read recovery (reference: src/cpptools/extract_unmapped.cpp).

Copied from pangaea_tpu.asm.unmapped.

Contract:

- the depth file (jgi_summarize_bam_contig_depths format: header line
  starting ``contigName``; columns name, len, totalAvgDepth, ...) selects
  the contig set with totalAvgDepth >= cutoff; those names go to
  ``<out>.list`` (extract_unmapped.cpp:155-176).
- the name-sorted BAM is scanned in qname groups. A group is "unmapped"
  unless at least one alignment record (i) is mapped, (ii) hits a contig
  in the high-coverage set, (iii) has >= 60 M/I/D cigar columns, and
  (iv) has blast identity (cols - NM)/cols >= 0.95
  (extract_unmapped.cpp:72-121).
- for unmapped groups whose both mates were seen, the original read pair
  (reverse-complemented back to read orientation when the record is
  reverse-strand) is emitted to ``<out>.low_abd.fq`` as
  ``@name/1 .. @name/2`` records (extract_unmapped.cpp:124-135,220-231).
  The first record seen for each mate provides seq/qual
  (extract_unmapped.cpp:55-69) — including secondary/supplementary
  records, whose seq may be empty/hard-clipped; replicated as-is.
"""

from __future__ import annotations

from typing import Iterator, List, Set, TextIO, Tuple

from pangaea_tpu_torch.io.bam import BamReader, BamRecord, revcomp


def read_depth_file(path: str, cutoff: float) -> List[str]:
    """Names with totalAvgDepth (3rd column) >= cutoff, in file order."""
    keep = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if not parts or parts[0] == "contigName":
                continue
            if float(parts[2]) >= cutoff:
                keep.append(parts[0])
    return keep


def _iter_qname_groups(reader: BamReader) -> Iterator[List[BamRecord]]:
    group: List[BamRecord] = []
    last = None
    for rec in reader:
        if not rec.qname:
            continue
        if rec.qname != last and group:
            yield group
            group = []
        last = rec.qname
        group.append(rec)
    if group:
        yield group


def _record_passes(rec: BamRecord, contigs: Set[str], reader: BamReader,
                   min_cols: int, min_identity: float) -> bool:
    if rec.is_unmapped:
        return False
    name = reader.ref_name(rec.tid)
    if not name or name not in contigs:
        return False
    cols = rec.alignment_columns()
    if cols < min_cols:
        return False
    nm = rec.tags.get("NM", 0)
    if not isinstance(nm, int):
        nm = 0
    if cols == 0 or (cols - nm) / cols < min_identity:
        return False
    return True


def _mate_seq_qual(rec: BamRecord) -> Tuple[str, str]:
    """Original read orientation (extract_unmapped.cpp:11-53)."""
    if rec.is_reverse:
        return revcomp(rec.seq), rec.qual[::-1]
    return rec.seq, rec.qual


def extract_unmapped(bam_path: str, depth_path: str, cutoff: float,
                     out_prefix: str, min_cols: int = 60,
                     min_identity: float = 0.95) -> Tuple[int, int]:
    """Writes <out>.list + <out>.low_abd.fq; returns (n_groups, n_emitted)."""
    keep = read_depth_file(depth_path, cutoff)
    with open(out_prefix + ".list", "w") as f:
        for name in keep:
            f.write(name + "\n")
    contigs = set(keep)
    reader = BamReader(bam_path)
    n_groups = n_emitted = 0
    with open(out_prefix + ".low_abd.fq", "w") as out:
        for group in _iter_qname_groups(reader):
            n_groups += 1
            r1 = r2 = None
            mapped = False
            for rec in group:
                if rec.is_read1 and r1 is None and rec.seq:
                    r1 = _mate_seq_qual(rec)
                elif rec.is_read2 and r2 is None and rec.seq:
                    r2 = _mate_seq_qual(rec)
                if not mapped and _record_passes(rec, contigs, reader,
                                                min_cols, min_identity):
                    mapped = True
            if not mapped and r1 and r2:
                name = group[0].qname
                out.write(f"@{name}/1\n{r1[0]}\n+\n{r1[1]}\n"
                          f"@{name}/2\n{r2[0]}\n+\n{r2[1]}\n")
                n_emitted += 1
    return n_groups, n_emitted
