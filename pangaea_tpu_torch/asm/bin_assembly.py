"""Per-bin assembly + read mapback (reference: src/scripts/bin_assembly.sh).

Contract:
- every ``<cluster_dir>/*.fq`` is assembled (megahit, <= 5 concurrent,
  bin_assembly.sh:18-27); all contigs concatenate into
  ``contigs.megahit.fa`` renamed to ``contig_<n>`` headers (:28-30).
- all reads map back (bwa mem, ``-p`` when interleaved) into a
  position-sorted BAM, from which the jgi depth file and a name-sorted
  BAM are produced (:33-45); resume markers = the output files.

Backends: external (megahit + bwa + samtools + jgi, exact reference
behavior) when installed; builtin (asm/naive.py + asm/mapper.py on the
pipeline's device) otherwise. The builtin BAM is name-grouped by
construction. Copied from pangaea_tpu.asm.bin_assembly;
:func:`map_reads_to_contigs` takes the device its mapper runs on, and
both entry points record which backend ran (and, for the mapper, the
index and mapback seconds and base counts) in an optional ``stats``
dict.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, List, Optional

from pangaea_tpu_torch.asm.fasta import (concat_fastas, iter_fasta,
                                         rename_contigs)
from pangaea_tpu_torch.asm.tools import ToolRunner

if TYPE_CHECKING:  # the spawned bin workers import this module: no torch
    from pangaea_tpu_torch.utils import DeviceLike

log = logging.getLogger(__name__)


def _assemble_bins_external(runner: ToolRunner, fqs: List[str],
                            threads: int) -> List[str]:
    outs = []

    def one(fq):
        outdir = fq[:-3] + ".megahit"
        final = os.path.join(outdir, "final.contigs.fa")
        if not os.path.isfile(final):
            # resume on the OUTPUT file, not the directory: an
            # interrupted megahit leaves the dir without the fasta and
            # would wedge every rerun (megahit itself refuses an
            # existing dir, so clear a stale one first)
            if os.path.isdir(outdir):
                import shutil
                shutil.rmtree(outdir)
            runner.run(["megahit", "--12", fq, "-t", str(threads),
                        "-o", outdir], log_name="megahit.log")
        return final

    with ThreadPoolExecutor(max_workers=5) as ex:  # bin_assembly.sh:20-27
        outs = list(ex.map(one, fqs))
    return outs


def _assemble_one_builtin(args) -> int:
    """Process-pool worker: assemble one bin (module-level for pickle)."""
    fq, fa = args
    from pangaea_tpu_torch.asm.naive import assemble_fastq
    tmp = fa + ".tmp"
    n = assemble_fastq(fq, tmp)
    os.replace(tmp, fa)
    return n


def _assemble_bins_builtin(fqs: List[str]) -> List[str]:
    from concurrent.futures import ProcessPoolExecutor
    outs = []
    jobs = []
    for fq in fqs:
        outdir = fq[:-3] + ".megahit"
        os.makedirs(outdir, exist_ok=True)
        fa = os.path.join(outdir, "final.contigs.fa")
        outs.append(fa)
        if not os.path.isfile(fa):
            jobs.append((fq, fa))
    if jobs:
        # the vectorized assembler is numpy-bound; two worker PROCESSES
        # use both host cores (threads would share the GIL'd walk).
        # write-then-rename keeps the resume check crash-safe.
        # spawn, not fork: in a full steps-1-4 run this process holds a
        # CUDA context and torch's threads, which a forked child must not
        # inherit; the workers import only numpy (asm/naive.py).
        import multiprocessing
        workers = min(2, os.cpu_count() or 1, len(jobs))
        if workers > 1:
            with ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                for (fq, _), n in zip(jobs,
                                      ex.map(_assemble_one_builtin, jobs)):
                    log.info("builtin assembler: %s -> %d contigs", fq, n)
        else:
            for job in jobs:
                log.info("builtin assembler: %s -> %d contigs", job[0],
                         _assemble_one_builtin(job))
    return outs


def assemble_cluster_bins(cluster_dir: str, threads: int,
                          runner: Optional[ToolRunner] = None,
                          stats: Optional[dict] = None) -> str:
    """Produce <cluster_dir>/contigs.megahit.fa; returns its path."""
    runner = runner or ToolRunner()
    backend = (stats if stats is not None else {}).setdefault("backend", {})
    contigs_fa = os.path.join(cluster_dir, "contigs.megahit.fa")
    if os.path.isfile(contigs_fa):
        backend["bin_assembler"] = "resumed"
        return contigs_fa
    fqs = sorted(glob.glob(os.path.join(cluster_dir, "*.fq")))
    if runner.available("megahit"):
        backend["bin_assembler"] = "megahit"
        outs = _assemble_bins_external(runner, fqs, threads)
    else:
        log.warning("megahit not found; using builtin unitig assembler")
        backend["bin_assembler"] = "builtin"
        outs = _assemble_bins_builtin(fqs)
    concat_fastas(outs, contigs_fa)
    renamed = contigs_fa + ".renamed"
    rename_contigs(contigs_fa, renamed)  # parse_header (bin_assembly.sh:29)
    os.replace(renamed, contigs_fa)
    return contigs_fa


def map_reads_to_contigs(cluster_dir: str, assembly_dir: str, threads: int,
                         reads1: str, reads2: str = "",
                         runner: Optional[ToolRunner] = None,
                         device: DeviceLike = None,
                         stats: Optional[dict] = None) -> None:
    """Produce contigs.megahit.name_sorted.bam + contigs.megahit.depth.
    The builtin mapper runs on ``device`` (``cuda`` unless the caller asks
    for another)."""
    runner = runner or ToolRunner()
    stats = stats if stats is not None else {}
    backend = stats.setdefault("backend", {})
    os.makedirs(assembly_dir, exist_ok=True)
    contigs_fa = os.path.join(cluster_dir, "contigs.megahit.fa")
    name_sorted = os.path.join(assembly_dir, "contigs.megahit.name_sorted.bam")
    depth = os.path.join(assembly_dir, "contigs.megahit.depth")
    if os.path.isfile(name_sorted) and os.path.isfile(depth):
        backend["mapper"] = "resumed"
        return
    external = all(runner.available(t) for t in
                   ("bwa", "samtools", "jgi_summarize_bam_contig_depths"))
    if external:
        backend["mapper"] = "bwa"
        pos_bam = os.path.join(assembly_dir, "contigs.megahit.bam")
        if not os.path.isfile(contigs_fa + ".amb"):
            runner.run(["bwa", "index", contigs_fa], log_name="bwa.log")
        if reads2:
            cmd = (f"bwa mem -t {threads} {contigs_fa} {reads1} {reads2} | "
                   f"samtools sort -@ {threads} -o {pos_bam}")
        else:
            cmd = (f"bwa mem -p -t {threads} {contigs_fa} {reads1} | "
                   f"samtools sort -@ {threads} -o {pos_bam}")
        runner.run([], shell_cmd=cmd, log_name="bwa.log")
        runner.run(["jgi_summarize_bam_contig_depths", "--outputDepth",
                    depth, pos_bam], log_name="jgi.log")
        runner.run(["samtools", "sort", "-n", "-@", str(threads), pos_bam,
                    "-o", name_sorted], log_name="samtools.log")
        os.remove(pos_bam)
    else:
        log.warning("bwa/samtools/jgi not found; using builtin k-mer "
                    "vote mapper")
        backend["mapper"] = "builtin"
        from pangaea_tpu_torch.asm.mapper import (KmerMapper,
                                                  map_pairs_to_bam,
                                                  write_depth_file)
        from pangaea_tpu_torch.io.grouping import (
            iter_read_pairs_interleaved, iter_read_pairs_paired)
        from pangaea_tpu_torch.utils import synchronize
        t0 = time.perf_counter()
        contigs = list(iter_fasta(contigs_fa))
        mapper = KmerMapper(device=device)
        mapper.index_contigs(contigs)
        synchronize(mapper.device)
        stats["index_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if reads2:
            pairs = iter_read_pairs_paired(reads1, reads2)
        else:
            pairs = iter_read_pairs_interleaved(reads1)
        counts = {"read_pairs": 0, "read_bases": 0}

        def pair_tuples():
            for p in pairs:
                counts["read_pairs"] += 1
                counts["read_bases"] += len(p.seq1) + len(p.seq2)
                yield p.name, p.seq1, p.qual1, p.seq2, p.qual2

        bases = map_pairs_to_bam(mapper, pair_tuples(), name_sorted)
        write_depth_file(depth, mapper.contig_names, mapper.contig_lengths,
                         bases)
        stats["mapback_s"] = time.perf_counter() - t0
        stats.update(counts, mapped_bases=int(sum(bases.values())))
