"""OLC ensemble of sub-assemblies (reference: src/scripts/merge_olc.py).

Contract:
- align the pooled local contigs to the seed/template assembly (bwa mem);
  drop every contig whose alignment covers it to within 1000 bp of its
  full length ("fully contained", merge_olc.py:32-52).
- append SIX copies of the >= 1 kb seed contigs (1 initial + 5 appends,
  merge_olc.py:79-83) so the OLC consensus trusts the template.
- rename headers, then ``flye --meta --subassemblies --min-overlap 1000``
  produces ``final.asm.fa`` (merge_olc.py:85-93).

Builtin fallback (no bwa/flye): containment filtering via the k-mer
vote mapper (asm/mapper.py, on ``device``); the OLC consensus step
degrades to the deduplicated concatenation (a single seed copy instead of
six — without an OLC engine, multiplying copies only bloats output).
Copied from pangaea_tpu.asm.merge_olc, with ``device`` threaded through
and the backends that ran recorded in an optional ``stats`` dict.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import TYPE_CHECKING, Optional

from pangaea_tpu_torch.asm.fasta import (concat_fastas, fasta_sizes,
                                   filter_min_len, iter_fasta,
                                   rename_contigs)
from pangaea_tpu_torch.asm.tools import ToolRunner

if TYPE_CHECKING:
    from pangaea_tpu_torch.utils import DeviceLike

log = logging.getLogger(__name__)


def _filter_contained_external(runner: ToolRunner, seeds: str, local: str,
                               outdir: str, filt_fa: str) -> None:
    from pangaea_tpu_torch.io.bam import BamReader
    bam = os.path.join(outdir, "align-inputs.bam")
    if not os.path.isfile(bam):
        if not os.path.isfile(seeds + ".amb"):
            runner.run(["bwa", "index", seeds], log_name="bwa.log")
        runner.run([], shell_cmd=(
            f"bwa mem -t 100 {seeds} {local} | samtools view -bS - | "
            f"samtools sort -o {bam} -"), log_name="bwa.log")
        runner.run(["samtools", "index", bam], log_name="bwa.log")
    sizes = fasta_sizes(local)
    full = set()
    reader = BamReader(bam)
    for rec in reader:
        if rec.is_unmapped:
            continue
        qlen = sum(n for op, n in rec.cigar if op in "MI=X")
        if qlen + 1000 >= sizes[rec.qname]:  # merge_olc.py:41-43
            full.add(rec.qname)
    _write_filtered(local, full, filt_fa)


def _filter_contained_builtin(seeds: str, local: str, filt_fa: str,
                              device: DeviceLike = None) -> None:
    from pangaea_tpu_torch.asm.mapper import KmerMapper
    mapper = KmerMapper(device=device)
    mapper.index_contigs(list(iter_fasta(seeds)))
    names, seqs = zip(*[(n.split()[0], s) for n, s in iter_fasta(local)]) \
        if os.path.getsize(local) else ((), ())
    full = set()
    if names:
        best, votes, nvalid = mapper.map_reads(list(seqs))
        k = mapper.k
        for name, seq, v in zip(names, seqs, votes):
            aligned = int(v) + k - 1 if v > 0 else 0
            if aligned + 1000 >= len(seq):
                full.add(name)
    _write_filtered(local, full, filt_fa)


def _write_filtered(local: str, full_ctgs: set, filt_fa: str) -> None:
    with open(filt_fa, "w") as f:
        for name, seq in iter_fasta(local):
            if name.split()[0] not in full_ctgs:
                f.write(f">{name.split()[0]}\n{seq.upper()}\n")


def merge_olc(seeds: str, local: str, outdir: str,
              runner: Optional[ToolRunner] = None,
              seed_min_len: int = 1000, seed_copies: int = 6,
              flye_min_overlap: int = 1000, threads: int = 128,
              device: DeviceLike = None,
              stats: Optional[dict] = None) -> str:
    """Returns the path of final.asm.fa. The builtin containment filter
    maps on ``device`` (``cuda`` unless the caller asks for another)."""
    runner = runner or ToolRunner()
    backend = (stats if stats is not None else {}).setdefault("backend", {})
    os.makedirs(outdir, exist_ok=True)
    filt_fa = os.path.join(outdir, "pre-flye-input-contigs.filt.fa")
    seeds_fa = os.path.join(outdir, "seed-contigs.fa")
    merged_fa = os.path.join(outdir, "flye-input-contigs.fa")
    final_fa = os.path.join(outdir, "final.asm.fa")

    have_bwa = all(runner.available(t) for t in ("bwa", "samtools"))
    have_flye = runner.available("flye")

    if not os.path.isfile(merged_fa):
        if have_bwa:
            backend["containment"] = "bwa"
            _filter_contained_external(runner, seeds, local, outdir, filt_fa)
        else:
            log.warning("bwa not found; builtin containment filter")
            backend["containment"] = "builtin"
            _filter_contained_builtin(seeds, local, filt_fa, device)
        copies = seed_copies if have_flye else 1
        filter_min_len(seeds, seeds_fa, seed_min_len)
        for _ in range(copies - 1):
            filter_min_len(seeds, seeds_fa, seed_min_len, append=True)
        concat_fastas([filt_fa, seeds_fa], merged_fa)
        renamed = merged_fa + ".tmp"
        rename_contigs(merged_fa, renamed)
        os.replace(renamed, merged_fa)

    if not os.path.isfile(final_fa):
        backend["olc"] = "flye" if have_flye else "builtin"
        if have_flye:
            flye_dir = os.path.join(outdir, "flye-asm-1")
            flye_out = os.path.join(flye_dir, "assembly.fasta")
            if not os.path.isfile(flye_out):
                runner.run(["flye", "--meta", "--subassemblies", merged_fa,
                            "--out-dir", flye_dir, "--threads", str(threads),
                            "--min-overlap", str(flye_min_overlap)],
                           log_name="flye.log")
            shutil.copy(flye_out, final_fa)
        else:
            log.warning("flye not found; ensemble = filtered concatenation")
            shutil.copy(merged_fa, final_fa)
    return final_fa
