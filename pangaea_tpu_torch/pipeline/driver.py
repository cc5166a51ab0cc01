"""Top-level driver (reference: src/run_pangaea, 356-line bash); a copy of
pangaea_tpu/pipeline/driver.py on the port's modules.

Stages (src/run_pangaea:132-352):

  0. preprocess: stLFR/Tell-Seq header normalization; hybrid-mode virtual
     barcode assignment (long-read map -> bwa short->long -> add_barcode
     -> assign_barcodes); interleave; barcode sort.
  1. metaSPAdes on the short reads (external, hours).
  2. Athena: bwa mem -C alignment + athena-meta (external; the reference
     switches conda envs mid-run, src/run_pangaea:300-304 — here Athena is
     just an optional external command).
  3. the 4-step binning pipeline (pipeline/run.py) with -sp/-lc/-at wired
     to the metaspades/athena outputs; final_asm.fa copied up.

External assemblers stay external and run through ``asm.tools.ToolRunner``
with pangaea_tpu's command lines; every stage is resumable via
output-file existence, exactly like the reference. Without bwa and
samtools, hybrid mode maps the short reads to the long reads with the
port's k-mer vote mapper on ``--device``.

The flags are pangaea_tpu's (driver.py:224-250) plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions; a CUDA
device without a card raises) and ``--matmul_dtype``.

Usage: ``python -m pangaea_tpu_torch.pipeline.driver -s 10x -1 R1 -2 R2
-o out``
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, Optional

from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.io.fastq import barcode_sort_interleaved
from pangaea_tpu_torch.io.preprocess import (interleave, load_whitelist,
                                             preprocess_stlfr,
                                             preprocess_tellseq)
from pangaea_tpu_torch.profiling import span

log = logging.getLogger(__name__)


def _builtin_short2long(longreads: str, r1: str, r2: str, bam_path: str,
                        device=None) -> None:
    """bwa-less hybrid mapping: index the long reads with the device k-mer
    vote mapper and emit a name-grouped BAM of the short pairs (read by
    io/hybrid.add_barcode exactly like bwa's output)."""
    from pangaea_tpu_torch.asm.fasta import iter_fasta
    from pangaea_tpu_torch.asm.mapper import KmerMapper, map_pairs_to_bam
    from pangaea_tpu_torch.io.fastq import iter_fastq_records
    from pangaea_tpu_torch.io.grouping import iter_read_pairs_paired

    if _is_fasta(longreads):
        contigs = [(n.split()[0], s) for n, s in iter_fasta(longreads)]
    else:
        contigs = [(rec.header.split()[0], rec.seq)
                   for rec in iter_fastq_records(longreads)]
    mapper = KmerMapper(max_row_len=4096, device=device)
    mapper.index_contigs(contigs)
    pairs = ((p.name, p.seq1, p.qual1, p.seq2, p.qual2)
             for p in iter_read_pairs_paired(r1, r2))
    map_pairs_to_bam(mapper, pairs, bam_path)


def _is_fasta(path: str) -> bool:
    from pangaea_tpu_torch.io.fastq import open_maybe_gzip
    with open_maybe_gzip(path) as f:
        return f.read(1) == ">"


def preprocess_reads(args, reads_dir: str, runner: ToolRunner,
                     stats: Optional[Dict[str, float]] = None) -> str:
    """Step 0; returns the barcode-sorted interleaved FASTQ path.
    ``stats`` (when given) receives the seconds of each sub-stage run:
    ``preprocess_s`` (stLFR/Tell-Seq headers), ``barcode_map_s``,
    ``short2long_s``, ``add_barcode_s``, ``assign_s`` (hybrid),
    ``interleave_s`` and ``sort_s``."""
    stats = {} if stats is None else stats
    os.makedirs(reads_dir, exist_ok=True)
    r1, r2 = args.reads1, args.reads2
    if args.short_type == "stlfr":
        out1 = os.path.join(reads_dir, "stlfr_1.fq")
        if not os.path.isfile(out1):
            log.info("[stlfr] Preprocessing stlfr reads...")
            wl = (load_whitelist(args.whitelist) if args.whitelist else None)
            with span("step0.preprocess") as s:
                preprocess_stlfr(r1, r2, os.path.join(reads_dir, "stlfr"),
                                 numeric=wl is None, library=True,
                                 whitelist=wl)
            stats["preprocess_s"] = s.seconds
        r1, r2 = out1, os.path.join(reads_dir, "stlfr_2.fq")
    elif args.short_type == "tellseq":
        out1 = os.path.join(reads_dir, "tellseq_1.fq")
        if not os.path.isfile(out1):
            log.info("[tellseq] Preprocessing tellseq reads...")
            with span("step0.preprocess") as s:
                preprocess_tellseq(r1, r2, args.index,
                                   os.path.join(reads_dir, "tellseq"))
            stats["preprocess_s"] = s.seconds
        r1, r2 = out1, os.path.join(reads_dir, "tellseq_2.fq")

    sorted_fq = os.path.join(reads_dir, "interleaved_link_reads.sorted.fastq")
    if os.path.isfile(sorted_fq):
        log.info("Interleaved reads preparation done")
        return sorted_fq
    inter = os.path.join(reads_dir, "interleaved_link_reads.fastq")
    if args.longreads:
        # hybrid mode (src/run_pangaea:167-218)
        from pangaea_tpu_torch.io.hybrid import (add_barcode,
                                                 assign_barcodes,
                                                 make_longread_barcode_map)
        bc_map = os.path.join(reads_dir, "barcode_maps.txt")
        if not os.path.isfile(bc_map):
            log.info("[hybrid] long-read barcode map")
            with span("step0.barcode_map") as s:
                make_longread_barcode_map(args.longreads, bc_map)
            stats["barcode_map_s"] = s.seconds
        s2l_bam = os.path.join(reads_dir, "short2long.bam")
        if not os.path.isfile(s2l_bam):
            with span("step0.short2long") as s:
                if all(runner.available(t) for t in ("bwa", "samtools")):
                    if not os.path.isfile(args.longreads + ".bwt"):
                        log.info("[hybrid] bwa index")
                        runner.run(["bwa", "index", args.longreads],
                                   log_name="bwa.log")
                    log.info("[hybrid] bwa mem")
                    runner.run([], shell_cmd=(
                        f"bwa mem -t {args.threads} {args.longreads} {r1} "
                        f"{r2} | samtools sort -@ {args.threads} -n -o "
                        f"{s2l_bam} -"), log_name="bwa.log")
                else:
                    log.warning("[hybrid] bwa not found; builtin k-mer vote "
                                "mapper on %s", args.device)
                    _builtin_short2long(args.longreads, r1, r2, s2l_bam,
                                        device=args.device)
            stats["short2long_s"] = s.seconds
        short_map = os.path.join(reads_dir, "short_reads_barcoded_map.txt")
        if not os.path.isfile(short_map):
            log.info("[hybrid] add virtual barcode")
            with span("step0.add_barcode") as s:
                add_barcode(s2l_bam, bc_map,
                            os.path.join(reads_dir, "short_reads_barcoded"))
            stats["add_barcode_s"] = s.seconds
        if not os.path.isfile(inter):
            log.info("[hybrid] assign barcodes")
            with span("step0.assign") as s:
                assign_barcodes(short_map, r1, r2, inter + ".tmp")
            stats["assign_s"] = s.seconds
            os.replace(inter + ".tmp", inter)
    else:
        if not os.path.isfile(inter):
            log.info("[linked] Interleaving short reads")
            with span("step0.interleave") as s:
                interleave(r1, r2, inter + ".tmp")
            stats["interleave_s"] = s.seconds
            os.replace(inter + ".tmp", inter)
    log.info("Sorting linked reads by barcode")
    # write-then-rename: resume checks are existence-based, so a sort
    # killed mid-write must not leave a truncated sorted_fq that a rerun
    # would silently accept
    tmp_sorted = sorted_fq + ".tmp"
    with span("step0.sort") as s:
        barcode_sort_interleaved(inter, tmp_sorted)
    stats["sort_s"] = s.seconds
    os.replace(tmp_sorted, sorted_fq)
    os.remove(inter)
    return sorted_fq


def run_metaspades(args, runner: ToolRunner) -> str:
    out_dir = os.path.join(args.output, "1_metaspades_out")
    contigs = os.path.join(out_dir, "contigs.fasta")
    if os.path.isfile(contigs):
        return contigs
    runner.require("metaspades.py")
    runner.run(["metaspades.py", "-1", args.reads1, "-2", args.reads2,
                "-t", str(args.threads), "-o", out_dir],
               log_name="metaspades.log")
    return contigs


def run_athena(args, sorted_fq: str, spades_contigs: str,
               runner: ToolRunner) -> tuple:
    """Returns (local_assembly_fa, athena_asm_fa). src/run_pangaea:271-306:
    bwa mem -C alignment of the sorted interleaved reads to the metaspades
    contigs, then ``athena-meta --force_reads --config config.json`` run
    from the athena output dir."""
    out_dir = os.path.join(args.output, "2_athena_out")
    athena_fa = os.path.join(out_dir, "results", "olc", "athena.asm.fa")
    local_fa = os.path.join(out_dir, "results", "olc",
                            "flye-input-contigs.fa")
    if os.path.isfile(athena_fa):
        log.info("athena done")
        return local_fa, athena_fa
    runner.require("athena-meta")
    os.makedirs(out_dir, exist_ok=True)
    contigs = os.path.realpath(spades_contigs)
    config = os.path.join(out_dir, "config.json")
    with open(config, "w") as f:  # exact reference layout (:280-288)
        f.write('{\n')
        f.write(f'    "ctgfasta_path": "{contigs}",\n')
        f.write('    "reads_ctg_bam_path": "align-reads.contigs.bam",\n')
        f.write(f'    "input_fqs": "{os.path.realpath(sorted_fq)}",\n')
        f.write('    "cluster_settings": {\n')
        f.write('        "cluster_type": "multiprocessing",\n')
        f.write(f'        "processes": {args.threads}\n')
        f.write('    }\n}\n')
    bam = os.path.join(out_dir, "align-reads.contigs.bam")
    if not os.path.isfile(bam):
        for tool in ("bwa", "samtools"):
            runner.require(tool)
        if not os.path.isfile(contigs + ".bwt"):
            runner.run(["bwa", "index", contigs], log_name="bwa.log")
        runner.run([], shell_cmd=(
            f"bwa mem -t {args.threads} -C {contigs} {sorted_fq}"
            f" | samtools sort -@ {args.threads} -o {bam}"),
            log_name="bwa.log")
        runner.run(["samtools", "index", "-@", str(args.threads), bam],
                   log_name="bwa.log")
    runner.run(["athena-meta", "--force_reads", "--config", "config.json"],
               log_name="athena.log", cwd=out_dir)
    return local_fa, athena_fa


def make_hybrid_template(args, runner: ToolRunner,
                         longreads_type: str = "pacbio",
                         hybrid_asm: str = "hybridspades") -> str:
    """Hybrid template contigs (src/run_pangaea:311-333): hybridspades
    (metaspades --pacbio/--nanopore) or metaplatanus."""
    if hybrid_asm == "hybridspades" and runner.available("metaspades.py"):
        out_dir = os.path.join(args.output, "3_hybridspades_out")
        contigs = os.path.join(out_dir, "contigs.fasta")
        if not os.path.isfile(contigs):
            flag = ("--nanopore" if longreads_type == "nanopore"
                    else "--pacbio")
            runner.run(["metaspades.py", "-1", args.reads1, "-2",
                        args.reads2, flag, args.longreads, "-t",
                        str(args.threads), "-o", out_dir],
                       log_name="hybridspades.log")
        return contigs
    if runner.available("metaplatanus"):
        out_dir = os.path.join(args.output, "3_metaplatanus_out")
        os.makedirs(out_dir, exist_ok=True)
        contigs = os.path.join(out_dir, "out_final.fa")
        if not os.path.isfile(contigs):
            runner.run(["metaplatanus", "-IP1", args.reads1, args.reads2,
                        "-p", args.longreads, "-t", str(args.threads),
                        "-o", os.path.join(out_dir, "out"), "-m", "500"],
                       log_name="metaplatanus.log")
        return contigs
    log.warning("no hybrid template assembler available")
    return ""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="run_pangaea_tpu_torch")
    p.add_argument("-s", "--short_type", default="10x",
                   choices=["short", "stlfr", "tellseq", "10x"])
    p.add_argument("-1", "--reads1", required=True)
    p.add_argument("-2", "--reads2", required=True)
    p.add_argument("-l", "--longreads", default="",
                   help="long reads (hybrid mode)")
    p.add_argument("-I", "--index", default="",
                   help="Tell-Seq barcode index fastq")
    p.add_argument("-w", "--whitelist", default="",
                   help="stLFR barcode whitelist")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-m", "--metaphlan_db", default="")
    p.add_argument("-c", "--clusters", type=int, default=30)
    p.add_argument("-t", "--threads", type=int, default=50)
    p.add_argument("-st", "--steps", type=str, default="1,2,3,4")
    p.add_argument("--skip-external", action="store_true",
                   help="skip metaspades/athena (binning-only run)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    p.add_argument("--matmul_dtype", choices=("float32", "bfloat16"),
                   default="float32", help="VAE matmul precision")
    return p


def main(argv=None) -> dict:
    """Runs the driver; returns ``{"step0_s": {sub-stage: seconds},
    "pipeline": the Pipeline that ran steps 1-4}``."""
    args = build_parser().parse_args(argv)
    from pangaea_tpu_torch.utils import init_all, resolve_device
    resolve_device(args.device)  # no card for cuda raises before step 0
    # -t is the external tools' and step 3's; torch's threads stay as set
    init_all(seed=2021, threads=0, logfile="log", level=logging.INFO,
             outdir=args.output)
    log.info("command: %s", " ".join(sys.argv))
    runner = ToolRunner(log_dir=os.path.join(args.output, "logs"))

    reads_dir = os.path.join(args.output, "0_preprocess_reads")
    step0: Dict[str, float] = {}
    sorted_fq = preprocess_reads(args, reads_dir, runner, stats=step0)
    log.info("step 0 seconds: %s", {k: round(v, 3)
                                    for k, v in step0.items()})

    spades = local = athena = ""
    if not args.skip_external and runner.available("metaspades.py"):
        spades = run_metaspades(args, runner)
        if runner.available("athena-meta"):
            local, athena = run_athena(args, sorted_fq, spades, runner)
        else:
            log.warning("athena-meta not found; ensemble without athena")
        if args.longreads:
            # hybrid: the binning template is the hybrid assembly
            # (src/run_pangaea:311-333), falling back to metaspades
            template = make_hybrid_template(args, runner)
            spades = template or spades
    else:
        log.warning("metaspades unavailable/skipped; ensemble without seeds")

    from pangaea_tpu_torch.pipeline import cli
    from pangaea_tpu_torch.pipeline.run import Pipeline
    # the binning CLI's own parser supplies every field config_from_args
    # reads, at the values pangaea_tpu's driver passes (its defaults)
    sub = cli.build_parser().parse_args([
        "-i", sorted_fq, "-o", args.output, "-t", str(args.threads),
        "-c", str(args.clusters), "-st", args.steps, "-sp", spades,
        "-lc", local, "-at", athena, "-m", args.metaphlan_db,
        "--matmul_dtype", args.matmul_dtype, "--device", args.device])
    pipe = Pipeline(cli.config_from_args(sub), device=args.device)
    pipe.run()
    return {"step0_s": step0, "pipeline": pipe}


if __name__ == "__main__":
    main()
