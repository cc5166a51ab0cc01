"""Circularization pass (reference: third_parties/Lathe/Snakefile:14-210).

Copied from pangaea_tpu.asm.circularize without its two unused helpers
(``extract_long_contigs``, ``terminal_windows``); ``make_circularizer``
takes the port's ``PangaeaConfig``.

The reference drives Lathe's snakemake workflow for the final
circularization (merge_asm.sh:36-44), feeding it the pooled contigs fasta
as its "reads" (merge_asm.sh:38), with a plain-copy fallback when the
workflow fails. The full workflow, reproduced here:

  1. candidate genomes: contigs > 1.7 Mb (Snakefile:20-34);
  2. terminal reads: pool entries aligned within the 50 kb termini of
     each candidate (circularize_bam2reads, Snakefile:36-49);
  3. spanner assembly: flye --subassemblies over those reads
     (circularize_assemble, Snakefile:51-66);
  4. span test: align spanners to the candidate, keep (tig, spanner)
     pairs with >= 2 alignments, and detect the terminal-pair span events
     (circularize_spantig_pre/spantig, Snakefile:68-105 + spancircle.py):
     overlap => trim to ``tig[:len-trim]``; gap => keep the whole tig and
     APPEND the spanner's insert slice (circularize_span_trim run block,
     Snakefile:119-135);
  5. over-circularization: nucmer self-alignment corner-cut test on
     candidates not already span-circularized (circularize_overcirc,
     Snakefile:150-185 + encircle.py);
  6. final: circularized sequences replace their originals
     (circularize_final, Snakefile:190-210).

External tools used when installed: flye (step 3), nucmer/show-coords
(steps 4-5, with the Snakefile's exact flags). Every seam has a builtin
floor so the hermetic pipeline still completes: the exact-anchor chain
aligner + naive unitig assembler stand in for nucmer/flye (clearly
logged; DESIGN.md §8). Divergence from Lathe: a tig that span-circularizes
skips the overcirc test (Lathe runs both and can emit the tig twice,
Snakefile:190-199 collects *_spanned.fa AND *_overcirc.fa).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

from pangaea_tpu_torch.asm.circular_logic import (CoordRow, SpanEvent,
                                            anchor_chain_coords,
                                            exact_overlap_trim,
                                            overcirc_region,
                                            parse_show_coords, span_events,
                                            terminal_read_names)
from pangaea_tpu_torch.asm.fasta import iter_fasta, write_fasta
from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.config import PangaeaConfig

log = logging.getLogger(__name__)


def pull_terminal_reads(tig_seq: str, reads_fa: str, out_fa: str,
                        window: int = 50_000) -> int:
    """circularize_bam2reads (Snakefile:36-49): the pool entries aligned
    within the candidate's terminal windows. The reference filters by BAM
    position; here membership comes from exact-anchor hits against the
    termini, which agrees for the near-identical pool-vs-candidate case
    this stage compares."""
    picked = []
    names = set(terminal_read_names(
        tig_seq, iter_fasta(reads_fa), window=window))
    for name, seq in iter_fasta(reads_fa):
        if name in names:
            picked.append((name, seq))
    write_fasta(out_fa, picked)
    return len(picked)


def assemble_spanners(term_fa: str, workdir: str, runner: ToolRunner,
                      threads: int = 4) -> List[Tuple[str, str]]:
    """circularize_assemble (Snakefile:51-66): flye --subassemblies over
    the terminal reads; builtin floor = the naive unitig assembler."""
    if runner.available("flye"):
        runner.run(["flye", "-t", str(threads), "--subassemblies", term_fa,
                    "-o", workdir, "-g", "1m"], log_name="flye_span.log")
        asm = os.path.join(workdir, "assembly.fasta")
        if os.path.exists(asm):
            return list(iter_fasta(asm))
        return []
    from pangaea_tpu_torch.asm.naive import assemble_unitigs
    log.info("flye not found; builtin unitig assembler for spanners")
    seqs = [s for _n, s in iter_fasta(term_fa)]
    tigs = assemble_unitigs(seqs, k=31, min_len=200)
    return [(f"span_{i}", s) for i, s in enumerate(tigs)]


def span_alignment_rows(tig_name: str, tig_seq: str,
                        spanners: List[Tuple[str, str]], workdir: str,
                        runner: ToolRunner) -> List[CoordRow]:
    """circularize_spantig_pre (Snakefile:68-105): spanner-vs-candidate
    rows, keeping only (tig, spanner) pairs with >= 2 alignments. nucmer
    -b 5000 + delta-filter -q + show-coords -Tql when installed; builtin
    floor = the exact-anchor chain aligner."""
    rows: List[CoordRow] = []
    if runner.available("nucmer") and runner.available("show-coords"):
        import subprocess
        tig_fa = os.path.join(workdir, f"{tig_name}.target.fa")
        span_fa = os.path.join(workdir, f"{tig_name}.spanners.fa")
        write_fasta(tig_fa, [(tig_name, tig_seq)])
        write_fasta(span_fa, spanners)
        prefix = os.path.join(workdir, f"{tig_name}.spanning_tigs_to_ref")
        runner.run(["nucmer", "-b", "5000", tig_fa, span_fa, "-p", prefix],
                   log_name="nucmer_span.log")
        filt = prefix + ".filt.delta"
        with open(filt, "w") as f:
            subprocess.run(["delta-filter", "-q", prefix + ".delta"],
                           stdout=f, check=True)
        coords = subprocess.run(["show-coords", "-Tql", filt],
                                capture_output=True, text=True,
                                check=True).stdout
        rows = parse_show_coords("\n".join(coords.splitlines()[4:]))
    else:
        log.info("nucmer not found; builtin anchor-chain span alignment")
        for q_name, q_seq in spanners:
            rows += anchor_chain_coords(tig_name, tig_seq, q_name, q_seq)
        rows.sort(key=lambda r: (r.q_name, min(r.q_start, r.q_end)))
    # >= 2 alignments per (tig, spanner) pair (Snakefile:92-96)
    from collections import Counter
    pair_counts = Counter((r.r_name, r.q_name) for r in rows)
    return [r for r in rows if pair_counts[(r.r_name, r.q_name)] >= 2]


def apply_span_event(tig_seq: str, events: List[SpanEvent],
                     spanners: Dict[str, str]) -> Optional[str]:
    """circularize_span_trim run block (Snakefile:119-135): only the
    FIRST event applies — trim keeps ``tig[:keep_end]``; a gap keeps the
    whole tig and appends the spanner's insert slice (1-based inclusive
    faidx region)."""
    if not events:
        return None
    ev = events[0]
    if ev.keep_end is not None:
        return tig_seq[:ev.keep_end]
    q_name, lo, hi = ev.insert
    if q_name not in spanners:
        return None
    return tig_seq + spanners[q_name][lo - 1:hi]


def _overcirc_external(runner: ToolRunner, name: str, seq: str,
                       workdir: str):
    """encircle path: nucmer self-alignment -> smoothed corner-cut test."""
    import subprocess

    tig_fa = os.path.join(workdir, f"{name}.fa")
    write_fasta(tig_fa, [(name, seq)])
    delta = os.path.join(workdir, name)
    # encircle.py:19-27 parameters
    runner.run(["nucmer", "-p", delta, "-b", "4000", "-l", "2000",
                "--maxmatch", tig_fa, tig_fa], log_name="nucmer.log")
    coords = subprocess.run(
        ["show-coords", "-T", "-L", "2000", delta + ".delta"],
        capture_output=True, text=True, check=True).stdout
    # sed '1,5d' in encircle.py:24-26: 4 header lines AND the
    # full-length identity self-hit row must both go — keeping the
    # identity row would pass the corner tests on its own and truncate
    # non-circular contigs
    rows = parse_show_coords("\n".join(coords.splitlines()[5:]))
    region = overcirc_region(rows)
    if region is None:
        return "not_circular"
    start, end = region
    return seq[start - 1:end]  # 1-based inclusive region kept


def make_circularizer(cfg: PangaeaConfig, runner: ToolRunner
                      ) -> Optional[Callable[[str, str, str], str]]:
    """Returns circularize(contigs, reads, workdir) -> out_fa running the
    full Lathe workflow (module docstring): span circularization via
    terminal-read spanner assembly first, over-circularization trim for
    the rest, originals replaced in the output fasta."""

    def circularize(contigs_fa: str, reads_fa: str, workdir: str) -> str:
        circ_dir = os.path.join(workdir, "circular")
        os.makedirs(circ_dir, exist_ok=True)
        min_size = cfg.assembly.circularize_min_size
        window = cfg.assembly.terminal_window
        use_nucmer = runner.available("nucmer")
        out_fa = os.path.join(circ_dir, "circularized.fasta")
        n_span = n_over = 0

        def try_span(short: str, seq: str) -> Optional[str]:
            tdir = os.path.join(circ_dir, short)
            os.makedirs(tdir, exist_ok=True)
            term_fa = os.path.join(tdir, f"{short}_terminal_reads.fa")
            if pull_terminal_reads(seq, reads_fa, term_fa,
                                   window=window) == 0:
                return None
            spanners = assemble_spanners(term_fa, tdir, runner,
                                         threads=cfg.threads or 4)
            if not spanners:
                return None
            rows = span_alignment_rows(short, seq, spanners, tdir, runner)
            events = [e for e in span_events(rows) if e.target == short]
            return apply_span_event(seq, events, dict(spanners))

        def gen():
            nonlocal n_span, n_over
            for name, seq in iter_fasta(contigs_fa):
                short = name.split()[0]
                if len(seq) >= min_size:
                    spanned = None
                    try:
                        spanned = try_span(short, seq)
                    except Exception as e:
                        log.warning("span circularization failed on %s: "
                                    "%s", short, e)
                    if spanned is not None:
                        log.info("span-circularized %s: %d -> %d bp",
                                 short, len(seq), len(spanned))
                        n_span += 1
                        yield f"{short}_spanned", spanned
                        continue
                    # three-way outcome: a trimmed sequence, the
                    # external detector's definitive "not circular"
                    # (Lathe leaves the contig untouched — the builtin
                    # floor must NOT then second-guess it), or None =
                    # external unavailable/failed -> builtin floor
                    trimmed = None
                    if use_nucmer:
                        try:
                            trimmed = _overcirc_external(runner, short, seq,
                                                         circ_dir)
                        except Exception as e:
                            log.warning("nucmer encircle failed on %s: %s",
                                        short, e)
                    if trimmed == "not_circular":
                        trimmed = None
                    elif trimmed is None:
                        keep = exact_overlap_trim(seq)
                        if keep is not None:
                            trimmed = seq[:keep]
                    if trimmed is not None:
                        log.info("circularized %s: %d -> %d bp", short,
                                 len(seq), len(trimmed))
                        n_over += 1
                        yield f"{short}_circularized", trimmed
                        continue
                yield name, seq

        write_fasta(out_fa, gen())
        log.info("circularization: %d spanned, %d overcirc-trimmed",
                 n_span, n_over)
        return out_fa

    return circularize
