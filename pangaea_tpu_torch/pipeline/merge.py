"""Standalone final-merge re-entry (reference: src/hybrid/final_merge.sh).

Port of pangaea_tpu/pipeline/merge.py. Re-runs the hybrid ensemble merge
from EXISTING pipeline artifacts with a chosen template type, without
re-running the pipeline — the reference ships this as a bare script for
users who want to swap the seed assembly (metaspades / hybridspades /
metaplatanus) after the fact.

Contract (src/hybrid/final_merge.sh:8-106):

- args: ``<path>`` (run root) and ``<type>`` in {metaspades,
  hybridspades, metaplatanus}; unknown type is an error naming the three
  valid choices (:60-69).
- required artifacts (:19-33): the pangaea output dir, athena's
  ``flye-input-contigs.fa`` + ``athena.asm.fa``, the 3.clustering and
  4.assembly dirs; a missing one aborts with "<path> does not exist!".
- seed contig per type (:37-39): ``metaspades_out/contigs.fasta``,
  ``hybridspades_out/contigs.fasta``,
  ``metaplatanus_out/_result/out_final.fa``.
- pool rebuild (:50-54): ``cat 4.assembly/*.spades/contigs.fasta
  3.clustering/contigs.megahit.fa <athena_local>`` ->
  ``contigs.low_abd.binning.local.fa`` renamed ``contig_<n>`` (also
  globbing ``*.megahit/final.contigs.fa``, as pangaea_tpu does, since
  low_assembly falls back spades -> megahit -> builtin).
- merge_olc into ``4.assembly/olc_<type>/``, skipped when
  ``final.asm.fa`` exists (:76-83); its builtin containment filter maps
  on ``device`` (the CUDA cummax of the k-mer vote mapper); quickmerge
  (``merge_wrapper.py <olc final> <athena realpath>`` run from
  ``quickmerge_<type>/``, an external tool with pangaea_tpu's argv) +
  the ``contig_<n>`` rename, skipped when ``merged_out.fasta`` exists
  (:88-102).
- final_merge.sh stops after quickmerge; ``--circularize`` appends the
  Lathe chain merge_asm uses.

Layout: the reference's flat layout (``<path>/pangaea_out`` +
``<path>/athena_out`` + ``<path>/*_out``) and the driver's layout
(``<path>`` itself the pipeline output with ``1_metaspades_out`` /
``2_athena_out`` / ``3_hybridspades_out`` inside).

The renamed pool and ``merged_out.fasta`` are written through
:func:`utils.replacing` (a unique temp name, then rename), unlike
pangaea_tpu's fixed ``.tmp`` names.

Usage: ``python -m pangaea_tpu_torch.pipeline.merge <path> <type>
[--circularize] [-t N] [--device D]``
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import shutil
from typing import Optional

from pangaea_tpu_torch.asm.fasta import concat_fastas, rename_contigs
from pangaea_tpu_torch.asm.merge_olc import merge_olc
from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.utils import DeviceLike, replacing

log = logging.getLogger(__name__)

MERGE_TYPES = ("metaspades", "hybridspades", "metaplatanus")


class MergeLayout:
    """Resolved artifact paths for one run root (reference layout first,
    driver layout fallback)."""

    def __init__(self, path: str):
        self.root = os.path.realpath(path)

        def pick(*cands: str) -> str:
            for c in cands:
                if os.path.exists(c):
                    return c
            return cands[0]

        r = self.root
        self.pangaea_out = pick(os.path.join(r, "pangaea_out"), r)
        athena_root = pick(os.path.join(r, "athena_out"),
                           os.path.join(r, "2_athena_out"))
        self.athena_local = os.path.join(athena_root, "results", "olc",
                                         "flye-input-contigs.fa")
        self.athena = os.path.join(athena_root, "results", "olc",
                                   "athena.asm.fa")
        self.cluster_dir = os.path.join(self.pangaea_out, "3.clustering")
        self.assembly_dir = os.path.join(self.pangaea_out, "4.assembly")
        self.seeds = {
            "metaspades": pick(
                os.path.join(r, "metaspades_out", "contigs.fasta"),
                os.path.join(r, "1_metaspades_out", "contigs.fasta")),
            "hybridspades": pick(
                os.path.join(r, "hybridspades_out", "contigs.fasta"),
                os.path.join(r, "3_hybridspades_out", "contigs.fasta")),
            "metaplatanus": pick(
                os.path.join(r, "metaplatanus_out", "_result",
                             "out_final.fa"),
                os.path.join(r, "3_metaplatanus_out", "out_final.fa")),
        }

    def validate(self) -> None:
        """final_merge.sh:26-33 existence asserts."""
        for p in (self.pangaea_out, self.athena_local, self.athena,
                  self.cluster_dir, self.assembly_dir):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"Directory or file {p} does not exist!")
            log.info("Directory or file %s exists.", p)


def _rename_in_place(path: str) -> None:
    """parse_header's ``contig_<n>`` rename of ``path`` onto itself."""
    with replacing(path) as tmp:
        rename_contigs(path, tmp)


def rebuild_pool(layout: MergeLayout) -> str:
    """final_merge.sh:50-54: concat reassemblies + binned contigs +
    athena local contigs, renamed contig_<n>."""
    pool = os.path.join(layout.assembly_dir,
                        "contigs.low_abd.binning.local.fa")
    fai = pool + ".fai"
    if os.path.isfile(fai):  # :47-49
        os.remove(fai)
    log.info("Concatenating contigs")
    sub_fas = sorted(
        glob.glob(os.path.join(layout.assembly_dir, "*.spades",
                               "contigs.fasta"))
        + glob.glob(os.path.join(layout.assembly_dir, "*.megahit",
                                 "final.contigs.fa")))
    inputs = sub_fas + [os.path.join(layout.cluster_dir,
                                     "contigs.megahit.fa"),
                        layout.athena_local]
    concat_fastas([p for p in inputs if os.path.isfile(p)], pool)
    _rename_in_place(pool)
    log.info("Concatenating done")
    return pool


def final_merge(path: str, merge_type: str,
                runner: Optional[ToolRunner] = None,
                circularize: bool = False, threads: int = 0,
                device: DeviceLike = None,
                stats: Optional[dict] = None) -> str:
    """Run the standalone merge; returns the final assembly path. The
    builtin containment filter maps on ``device`` (``cuda`` unless the
    caller asks for another); ``stats`` receives merge_olc's backends."""
    if merge_type not in MERGE_TYPES:
        raise ValueError(
            f"Unknown type: {merge_type}. Please specify 'metaspades', "
            "'hybridspades', or 'metaplatanus'. If you want to run "
            "operams, please install operams by your own")
    runner = runner or ToolRunner()
    layout = MergeLayout(path)
    layout.validate()
    pool = rebuild_pool(layout)

    seed = layout.seeds[merge_type]
    log.info("%s", merge_type)
    log.info("%s", seed)
    if not os.path.isfile(seed):
        # final_merge.sh:72-75 logs and carries on (its `continue` is a
        # loop leftover; the merge cannot proceed without the seed)
        raise FileNotFoundError(f"contig:  {seed} not exist!")

    olc_dir = os.path.join(layout.assembly_dir, f"olc_{merge_type}")
    olc_final = os.path.join(olc_dir, "final.asm.fa")
    if not os.path.isfile(olc_final):  # :76-83 resume
        log.info("Performing olc based on %s", merge_type)
        olc_final = merge_olc(seed, pool, olc_dir, runner=runner,
                              device=device, stats=stats)
        log.info("olc based on %s done", merge_type)
    else:
        log.info("olc based on %s already done", merge_type)

    qm_dir = os.path.join(layout.assembly_dir, f"quickmerge_{merge_type}")
    merged_out = os.path.join(qm_dir, "merged_out.fasta")
    if not os.path.isfile(merged_out):  # :88-102 resume
        os.makedirs(qm_dir, exist_ok=True)
        if runner.available("merge_wrapper.py"):
            log.info("Performing final quickmerge based on %s", merge_type)
            runner.run(["merge_wrapper.py",
                        os.path.relpath(olc_final, qm_dir),
                        os.path.realpath(layout.athena)],
                       log_name="quickmerge.log", cwd=qm_dir)
            _rename_in_place(merged_out)
            log.info("quickmerge based on %s done", merge_type)
        else:
            log.warning("quickmerge not found; copying olc result")
            with replacing(merged_out) as tmp:
                shutil.copy(olc_final, tmp)
    else:
        log.info("quickmerge based on %s already done", merge_type)

    final_fa = merged_out
    if circularize:
        from pangaea_tpu_torch.asm.circularize import make_circularizer
        from pangaea_tpu_torch.config import PangaeaConfig
        from pangaea_tpu_torch.utils import cpu_count
        cfg = PangaeaConfig(output=layout.pangaea_out,
                            threads=threads or cpu_count())
        circ = make_circularizer(cfg, runner)
        if circ is not None:
            try:
                final_fa = circ(merged_out, pool, qm_dir)
            except Exception as e:  # merge_asm.sh:39-44 fallback
                log.warning("circularization failed (%s); using "
                            "merged_out", e)
    log.info("all done")
    return final_fa


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="pangaea_tpu_torch-merge",
        description="Re-run the final ensemble merge from existing "
                    "artifacts with a chosen template type "
                    "(src/hybrid/final_merge.sh)")
    p.add_argument("path", help="run root (reference layout or the "
                                "driver's output dir)")
    p.add_argument("type", choices=MERGE_TYPES)
    p.add_argument("--circularize", action="store_true",
                   help="append the Lathe circularization chain "
                        "(final_merge.sh itself stops at quickmerge)")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="device of the builtin containment filter "
                        "(default cuda; 'cpu' runs without a card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s (%(levelname)s): %(message)s")
    out = final_merge(args.path, args.type, circularize=args.circularize,
                      threads=args.threads, device=args.device)
    print(out)


if __name__ == "__main__":
    main()
