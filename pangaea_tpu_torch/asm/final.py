"""Step-4 driver: multi-threshold reassembly + ensemble.

Port of pangaea_tpu/asm/final.py. Contract (reference
src/clustering.py:132-164 ``final_assemble`` +
src/scripts/low_abd_reads.sh, low_assembly.sh, merge_asm.sh):

1. thread cap 150 (clustering.py:142-143).
2. bin_assembly: per-bin megahit + read mapback (asm/bin_assembly.py).
3. per coverage cutoff (default "10,30"): extract reads with no good
   alignment to >=cutoff contigs -> ``contigs.megahit_cut<cf>.low_abd.fq``
   and the high-coverage contig subset (low_abd_reads.sh:9-12).
4. reassemble each low-abd read set (megahit or metaspades
   ``--untrusted-contigs``), 5-way concurrent (clustering.py:156-159).
5. merge: low-abd assemblies + binned contigs + athena local contigs ->
   renamed pool; merge_olc vs the seed assembly; quickmerge vs the athena
   assembly; Lathe circularization with plain-copy fallback
   (merge_asm.sh:14-44); result copied to ``<output>/final_asm.fa``
   (src/run_pangaea:352).

The host logic is pangaea_tpu's. The device work is the builtin mapper
(read mapback and merge_olc's containment filter), which runs on the
``device`` passed to :func:`final_assemble`. ``stats`` collects the
seconds of each sub-stage (``bins_s``, ``index_s``, ``mapback_s``,
``low_abd_s``, ``reassembly_s``, ``merge_s``, ``circularize_s``), the
mapback's read and mapped base counts, the low-abundance pairs per
cutoff, and which backend ran for each tool (``backend``).
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from pangaea_tpu_torch.asm.bin_assembly import (assemble_cluster_bins,
                                                map_reads_to_contigs)
from pangaea_tpu_torch.asm.fasta import (concat_fastas, read_name_list,
                                         rename_contigs, subseq)
from pangaea_tpu_torch.asm.merge_olc import merge_olc
from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.asm.unmapped import extract_unmapped
from pangaea_tpu_torch.config import PangaeaConfig
from pangaea_tpu_torch.utils import DeviceLike, resolve_device

log = logging.getLogger(__name__)


def low_abd_reads(cluster_dir: str, assembly_dir: str, covcut: int,
                  min_cols: int = 60, min_identity: float = 0.95
                  ) -> Optional[int]:
    """low_abd_reads.sh: extract_unmapped + seqtk subseq equivalent.
    Returns the pairs written, or None when the output already exists."""
    prefix = os.path.join(assembly_dir, f"contigs.megahit_cut{covcut}")
    if os.path.isfile(prefix + ".low_abd.fq"):
        return None
    _, n_emitted = extract_unmapped(
        os.path.join(assembly_dir, "contigs.megahit.name_sorted.bam"),
        os.path.join(assembly_dir, "contigs.megahit.depth"),
        covcut, prefix, min_cols=min_cols, min_identity=min_identity)
    subseq(os.path.join(cluster_dir, "contigs.megahit.fa"),
           read_name_list(prefix + ".list"), prefix + ".high_abd.fa")
    return n_emitted


def low_assembly(assembly_dir: str, seed_contigs: str, covcut: int,
                 threads: int, assembler: str,
                 runner: Optional[ToolRunner] = None) -> str:
    """low_assembly.sh: reassemble one low-abundance read set. Returns
    the backend that ran."""
    runner = runner or ToolRunner()
    fq = os.path.join(assembly_dir, f"contigs.megahit_cut{covcut}.low_abd.fq")
    if assembler == "spades" and runner.available("metaspades.py"):
        outdir = fq[:-3] + ".spades"
        if not os.path.isdir(outdir):
            runner.run(["metaspades.py", "--12", fq, "--only-assembler",
                        "-m", "5000", "-t", str(threads),
                        "--untrusted-contigs", seed_contigs, "-o", outdir],
                       log_name="spades.log")
        if not os.path.isfile(os.path.join(outdir, "contigs.fasta")):
            runner.run(["metaspades.py", "--continue", "-o", outdir],
                       log_name="spades.log")
        return "metaspades"
    if runner.available("megahit"):
        outdir = fq[:-3] + ".megahit"
        if not os.path.isfile(os.path.join(outdir, "final.contigs.fa")):
            runner.run(["megahit", "--12", fq, "-t", str(threads),
                        "-o", outdir], log_name="megahit.log")
        return "megahit"
    log.warning("no external assembler; builtin reassembly of %s", fq)
    from pangaea_tpu_torch.asm.naive import assemble_fastq
    outdir = fq[:-3] + ".megahit"
    os.makedirs(outdir, exist_ok=True)
    fa = os.path.join(outdir, "final.contigs.fa")
    if not os.path.isfile(fa):
        assemble_fastq(fq, fa)
    return "builtin"


def merge_asm(cluster_dir: str, assembly_dir: str, local_assembly: str,
              athena: str, seed_contigs: str, low_assembler: str,
              output_dir: str, runner: Optional[ToolRunner] = None,
              circularize=None, device: DeviceLike = None,
              stats: Optional[dict] = None) -> str:
    """merge_asm.sh: pool + merge_olc + quickmerge + circularize."""
    runner = runner or ToolRunner()
    stats = stats if stats is not None else {}
    backend = stats.setdefault("backend", {})
    t0 = time.perf_counter()
    pool = os.path.join(assembly_dir, "contigs.low_abd.binning.local.fa")
    # glob BOTH assembler layouts regardless of the configured name:
    # low_assembly falls back spades -> megahit -> builtin when tools are
    # missing, and a name-keyed glob would silently drop the recovered
    # low-abundance assemblies from the merge
    sub_fas = sorted(
        glob.glob(os.path.join(assembly_dir, "*.spades",
                               "contigs.fasta"))
        + glob.glob(os.path.join(assembly_dir, "*.megahit",
                                 "final.contigs.fa")))
    del low_assembler  # retained in the signature for callers
    inputs = sub_fas + [os.path.join(cluster_dir, "contigs.megahit.fa")]
    if local_assembly:
        inputs.append(local_assembly)
    concat_fastas(inputs, pool)
    renamed = pool + ".tmp"
    rename_contigs(pool, renamed)
    os.replace(renamed, pool)

    olc_dir = os.path.join(assembly_dir, "contigs.low_abd.binning.local.asm")
    if seed_contigs:
        olc_final = merge_olc(seed_contigs, pool, olc_dir, runner=runner,
                              device=device, stats=stats)
    else:
        log.warning("no seed contigs (-sp); skipping merge_olc seeding")
        backend["containment"] = backend["olc"] = "skipped (no -sp)"
        olc_final = pool

    qm_dir = os.path.join(assembly_dir, "quickmerge")
    os.makedirs(qm_dir, exist_ok=True)
    merged_out = os.path.join(qm_dir, "merged_out.fasta")
    if athena and runner.available("merge_wrapper.py"):
        backend["quickmerge"] = "merge_wrapper.py"
        runner.run(["merge_wrapper.py", os.path.relpath(olc_final, qm_dir),
                    os.path.realpath(athena)],
                   log_name="quickmerge.log", cwd=qm_dir)
        renamed = merged_out + ".tmp"
        rename_contigs(merged_out, renamed)
        os.replace(renamed, merged_out)
    else:
        if athena:
            log.warning("quickmerge not found; skipping athena merge")
        backend["quickmerge"] = ("skipped (not found)" if athena
                                 else "skipped (no -at)")
        shutil.copy(olc_final, merged_out)
    stats["merge_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    final_fa = os.path.join(output_dir, "final.asm.fa")
    done = False
    if circularize is not None:
        try:
            circ_out = circularize(merged_out, pool, qm_dir)
            shutil.copy(circ_out, final_fa)
            done = True
        except Exception as e:  # merge_asm.sh:39-44 fallback
            log.warning("circularization failed (%s); using merged_out", e)
    if not done:
        shutil.copy(merged_out, final_fa)
    stats["circularize_s"] = time.perf_counter() - t0
    return final_fa


def final_assemble(cfg: PangaeaConfig, cluster_dir: str,
                   assembly_dir: str, device: DeviceLike = None,
                   stats: Optional[dict] = None) -> str:
    """Step 4 on ``device`` (``cuda`` unless the caller asks for another;
    no card raises). Returns the path of ``final.asm.fa`` and leaves
    ``<output>/final_asm.fa`` and the ``assemble_finished`` marker."""
    device = resolve_device(device)
    stats = stats if stats is not None else {}
    backend = stats.setdefault("backend", {})
    runner = ToolRunner(log_dir=os.path.join(cfg.output, "logs"))
    threads = min(cfg.threads or (os.cpu_count() or 4), 150)
    os.makedirs(assembly_dir, exist_ok=True)
    cutoffs = [int(c) for c in cfg.assembly.low_abd_cut.split(",")]

    log.info("mapping reads to contigs")
    t0 = time.perf_counter()
    assemble_cluster_bins(cluster_dir, threads, runner, stats=stats)
    stats["bins_s"] = time.perf_counter() - t0
    map_reads_to_contigs(cluster_dir, assembly_dir, threads,
                         cfg.reads1 or cfg.interleaved_reads, cfg.reads2,
                         runner, device=device, stats=stats)
    log.info("obtaining reads mapped to low-abundance contigs")
    t0 = time.perf_counter()
    stats["low_abd_pairs"] = {
        cf: low_abd_reads(cluster_dir, assembly_dir, cf,
                          min_cols=cfg.assembly.min_aligned_columns,
                          min_identity=cfg.assembly.min_identity)
        for cf in cutoffs}
    stats["low_abd_s"] = time.perf_counter() - t0
    log.info("reassemble low-abundance contigs")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=cfg.assembly.max_concurrent_reassembly
                            ) as ex:
        ran = list(ex.map(lambda cf: low_assembly(
            assembly_dir, cfg.spades, cf, threads,
            cfg.assembly.low_assembler, runner), cutoffs))
    backend["reassembler"] = ",".join(sorted(set(ran)))
    stats["reassembly_s"] = time.perf_counter() - t0
    log.info("merge contigs with local assemblies")
    from pangaea_tpu_torch.asm.circularize import make_circularizer
    backend["circularizer"] = ",".join(
        t if runner.available(t) else f"builtin (no {t})"
        for t in ("flye", "nucmer"))
    final_fa = merge_asm(cluster_dir, assembly_dir, cfg.local_assembly,
                         cfg.athena, cfg.spades,
                         cfg.assembly.low_assembler, cfg.output,
                         runner=runner,
                         circularize=make_circularizer(cfg, runner),
                         device=device, stats=stats)
    shutil.copy(final_fa, os.path.join(cfg.output, "final_asm.fa"))
    with open(os.path.join(assembly_dir, "assemble_finished"), "w") as f:
        f.write("finished")
    return final_fa
