"""Bin materialization: split reads into per-cluster FASTQ files.

Copied from pangaea_tpu.io.extract_reads. :func:`extract_reads` runs the
native reader's ``pgn_extract_reads`` (C++, like the reference's
extract_reads; a failure raises).
Behavior contract (reference src/cpptools/extract_reads.cpp:40-197):

- clusters.tsv lines are ``<cluster_id>\\t<bc1>,<bc2>,...``; lines whose id
  is the string ``-1`` are skipped entirely (their barcodes get no bin).
- per kept tsv line, in order, two outputs open:
  ``<prefix>_bin<ID>.fq`` and ``<prefix>_bin<ID>.barcode`` (ID is the
  literal id string from the tsv).
- interleaved input (:88-127): for each pair whose barcode maps to a
  cluster, the R1 header is rewritten to ``<name>\\tBX:Z:<bc>-1`` while
  the R2 header passes through untouched; the pair's 8 lines go to the
  bin fq and the barcode is appended once to the .barcode file.
- paired input (:131-186): both headers are rewritten; pairs whose R1/R2
  name or barcode disagree are dropped; output is interleaved
  (R1 record then R2 record).
"""

from __future__ import annotations

from typing import List

from pangaea_tpu_torch.native import get_lib


def read_cluster_ids(path: str) -> List[str]:
    """The kept cluster ids of clusters.tsv, in file order."""
    ids: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            cid = line.partition("\t")[0]
            if line and cid != "-1":
                ids.append(cid)
    return ids


def _extract_reads_native(clusters_tsv: str, output_prefix: str,
                          reads1: str, reads2: str,
                          interleaved: str) -> None:
    """pgn_extract_reads (native/fastq_reader.cpp); raises on failure."""
    lib = get_lib()
    if interleaved:
        rc = lib.pgn_extract_reads(clusters_tsv.encode(),
                                   output_prefix.encode(),
                                   interleaved.encode(), b"", 1)
    else:
        rc = lib.pgn_extract_reads(clusters_tsv.encode(),
                                   output_prefix.encode(),
                                   reads1.encode(), reads2.encode(), 0)
    if rc < 0:
        raise OSError(f"native extract_reads failed for {clusters_tsv} "
                      f"-> {output_prefix}_bin*.fq (an unwritable output, "
                      f"or a missing, truncated or corrupt input)")


def extract_reads(clusters_tsv: str, output_prefix: str,
                  reads1: str = "", reads2: str = "",
                  interleaved: str = "") -> List[str]:
    """Split reads into bins (native reader); returns the list of
    written .fq paths."""
    if not (interleaved or (reads1 and reads2)):
        raise ValueError("reads must be specified")
    ids = read_cluster_ids(clusters_tsv)
    _extract_reads_native(clusters_tsv, output_prefix, reads1, reads2,
                          interleaved)
    return [f"{output_prefix}_bin{cid}.fq" for cid in ids]

