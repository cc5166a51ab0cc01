"""Circularization decision logic (reference: third_parties/Lathe).

Copied from pangaea_tpu.asm.circular_logic.

Pure-function ports of Lathe's two detectors, operating on parsed
alignment rows so they are testable without the external aligners:

- :func:`smooth_coords` + :func:`overcirc_region` — encircle.py: from a
  self-alignment coordinate table (nucmer show-coords -T rows), join
  near-colinear alignments (gap < 150 kb), drop inversions and short
  alignments, and report the "corner-cutting off-diagonal" region
  characteristic of over-circularization: the first smoothed alignment
  starts near the contig start and ends near the contig end
  (encircle.py:14-17,38-88).
- :func:`span_events` — spancircle.py: from alignments of a spanning
  contig against a target, detect pairs of terminal alignments by the
  same spanner: overlap => trim the wraparound
  (``target:1-(len-trim)``), gap => splice the spanner's insert
  (spancircle.py:10-75).
- :func:`exact_overlap_trim` — builtin fallback when nucmer/flye are
  absent: a suffix==prefix terminal repeat (k-mer anchored, exact
  verify) is the degenerate over-circularization case; trimming it
  yields the circular sequence.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

# encircle.py knobs (encircle.py:12-16)
SMOOTH_GAP_WIDTH = 150_000
CONTIG_EDGE_MARGIN = 150_000
MIN_SMOOTHED_ALN_LEN = 10_000
MIN_ALN_LEN = 5_000


@dataclass
class CoordRow:
    """One nucmer show-coords -T row: [S1 E1 S2 E2 LEN1 LEN2 IDY ...]."""
    r_start: int
    r_end: int
    q_start: int
    q_end: int
    r_len: int = 0
    q_len: int = 0
    r_name: str = ""
    q_name: str = ""


def smooth_coords(rows: Sequence[CoordRow]) -> List[List[int]]:
    """encircle.py:31-77: join colinear self-alignments into runs.

    Returns smoothed [r_start, r_end, q_start, q_end] quadruples.
    """
    lines = [[r.r_start, r.r_end, r.q_start, r.q_end] for r in rows]
    if not lines:
        return []
    smoothed: List[List[int]] = []
    aln_start = list(lines[0])
    prev = list(lines[0])
    for s in lines[1:] + [lines[0]]:
        if s[0] > s[1]:  # inversion
            continue
        if s[1] - s[0] < MIN_ALN_LEN:
            continue
        if (abs(s[0] - prev[1]) < SMOOTH_GAP_WIDTH
                and abs(s[2] - prev[3]) < SMOOTH_GAP_WIDTH):
            pass  # join
        else:
            newline = aln_start
            newline[1] = prev[1]
            newline[3] = prev[3]
            if newline[1] - newline[0] > MIN_SMOOTHED_ALN_LEN:
                smoothed.append(list(newline))
            aln_start = list(s)
        prev = list(s)
    return smoothed


def overcirc_region(rows: Sequence[CoordRow]
                    ) -> Optional[Tuple[int, int]]:
    """encircle.py:80-88: (start, end) 1-based region to KEEP, or None.

    max_tiglen is tracked as the largest E1 seen (encircle.py:43-44).
    """
    if not rows:
        return None
    max_tiglen = max(r.r_end for r in rows)
    smoothed = smooth_coords(rows)
    if not smoothed:
        return None
    first, last = smoothed[0], smoothed[-1]
    if (first[0] < CONTIG_EDGE_MARGIN
            and first[3] > max_tiglen - CONTIG_EDGE_MARGIN):
        if (last[2] < CONTIG_EDGE_MARGIN
                and last[1] > max_tiglen - CONTIG_EDGE_MARGIN):
            return first[0], last[0]
    return None


@dataclass
class SpanEvent:
    target: str
    keep_end: Optional[int] = None    # trim: keep target[1:keep_end]
    insert: Optional[Tuple[str, int, int]] = None  # splice spanner slice


def span_events(rows: Sequence[CoordRow], margin: int = 10_000
                ) -> List[SpanEvent]:
    """spancircle.py:10-75 on parsed rows (r = target, q = spanner)."""
    events: List[SpanEvent] = []
    prev: Optional[CoordRow] = None
    prev_is_terminal = False
    prev_q_end = 0
    for r in rows:
        r_start, r_end = sorted((r.r_start, r.r_end))
        q_start, q_end = sorted((r.q_start, r.q_end))
        if r_start < margin or r_end > r.r_len - margin:
            if q_start < margin or q_end > r.q_len - margin:
                if (prev_is_terminal and prev is not None
                        and r.q_name == prev.q_name
                        and r.r_name == prev.r_name):
                    if q_start < prev_q_end:  # overlap => trim
                        trim = prev_q_end - q_start
                        events.append(SpanEvent(r.r_name,
                                                keep_end=r.r_len - trim))
                    else:  # gap => splice spanner insert
                        lo, hi = sorted((q_start, prev_q_end))
                        events.append(SpanEvent(
                            r.r_name, insert=(r.q_name, lo, hi)))
                    prev_is_terminal = False
                    prev = r
                    prev_q_end = q_end
                    continue
                prev_is_terminal = True
            else:
                prev_is_terminal = False
        else:
            prev_is_terminal = False
        prev = r
        prev_q_end = q_end
    return events


def parse_show_coords(text: str) -> List[CoordRow]:
    """Parse ``show-coords -T`` output (tab-separated, headers stripped).

    Column layouts by count: 7 = S1 E1 S2 E2 LEN1 LEN2 IDY;
    9 = ... + TAGR TAGQ (plain ``-T``: the trailing fields are NAMES,
    not lengths — parsing them as LENR/LENQ raised and silently killed
    the external encircle path); 11 = ``-Tl``'s ... + LENR LENQ + tags.
    """
    rows = []
    for line in text.splitlines():
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 7:
            continue
        try:
            vals = [int(float(p)) for p in parts[:4]]
            if len(parts) >= 11:
                r_len = int(float(parts[7]))
                q_len = int(float(parts[8]))
            else:
                r_len = q_len = 0
        except ValueError:
            continue
        r_name = parts[-2] if len(parts) >= 9 else ""
        q_name = parts[-1] if len(parts) >= 9 else ""
        rows.append(CoordRow(vals[0], vals[1], vals[2], vals[3],
                             r_len, q_len, r_name, q_name))
    return rows


def exact_overlap_trim(seq: str, k: int = 31, min_overlap: int = 2_000,
                       max_overlap: int = 200_000) -> Optional[int]:
    """Builtin circularity test: longest terminal repeat seq[:L]==seq[-L:].

    Anchors on the first k-mer of the contig: every occurrence of
    seq[:k] inside the terminal window proposes L = len(seq) - pos;
    the largest verified L in [min_overlap, max_overlap] wins.
    Returns the KEEP length (len - L), or None if not circular.
    """
    n = len(seq)
    if n < 2 * min_overlap:
        return None
    anchor = seq[:k]
    window_start = max(n - max_overlap, min_overlap)
    pos = seq.find(anchor, window_start)
    best: Optional[int] = None
    while pos != -1:
        L = n - pos
        if min_overlap <= L <= max_overlap and seq[pos:] == seq[:L]:
            best = n - L
            break  # first hit in the window = largest L
        pos = seq.find(anchor, pos + 1)
    return best


# ---- builtin exact-anchor aligner (nucmer/minimap2 floor) -----------------
#
# Lathe maps its "reads" (Pangaea passes the pooled CONTIGS fasta,
# merge_asm.sh:38) to the candidate genome and later aligns the
# flye-assembled spanner back to it (Snakefile:36-49,68-105). When the
# external aligners are absent, these functions provide the floor: exact
# k-mer anchors chained by diagonal into alignment blocks. Exact-seed
# chaining is a real aligner for the near-identical sequences this stage
# compares (a contig vs pieces assembled FROM it); it is NOT a general
# aligner and is clearly logged as the builtin path by the caller.

from pangaea_tpu_torch.kernels.encode import kmer_positions_np as \
    _kmer_positions  # shared host-side windowing (kernels/encode.py)


def _revcomp_str(seq: str) -> str:
    tr = str.maketrans("ACGTacgt", "TGCAtgca")
    return seq.translate(tr)[::-1]


def anchor_hits(t_vals, t_pos, q_seq: str, k: int, max_occ: int = 4):
    """(q_positions, r_positions) of exact shared k-mers. t_vals must be
    value-sorted with t_pos aligned. A k-mer occurring at several target
    loci yields a hit per locus (capped at ``max_occ``) — an
    over-circularized contig duplicates its terminal sequence, and the
    spanner must anchor to BOTH copies for the trim diagonal to form
    (spancircle.py's overlap test)."""
    import numpy as np
    q_vals, q_pos = _kmer_positions(q_seq, k)
    if len(q_vals) == 0 or len(t_vals) == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    lo = np.searchsorted(t_vals, q_vals, side="left")
    hi = np.searchsorted(t_vals, q_vals, side="right")
    cnt = np.minimum(hi - lo, max_occ)
    m = cnt > 0
    q_pos, lo, cnt = q_pos[m], lo[m], cnt[m]
    out_q = np.repeat(q_pos, cnt)
    # lo[i], lo[i]+1, ..., lo[i]+cnt[i]-1 for each hit group
    offs = np.arange(len(out_q)) - np.repeat(
        np.cumsum(cnt) - cnt, cnt)
    out_r = t_pos[np.repeat(lo, cnt) + offs]
    return out_q, out_r


def target_index(seq: str, k: int = 21):
    """Value-sorted k-mer values + aligned positions of seq (all
    occurrences kept; anchor_hits caps per-k-mer fan-out)."""
    import numpy as np
    vals, pos = _kmer_positions(seq, k)
    order = np.argsort(vals, kind="stable")
    return vals[order], pos[order]


def anchor_chain_coords(t_name: str, t_seq: str, q_name: str, q_seq: str,
                        k: int = 21, min_block: int = 1_000,
                        max_gap: int = 200) -> List[CoordRow]:
    """Alignment blocks of q against t as show-coords-style rows.

    Exact k-mer anchors are grouped by diagonal (r_pos - q_pos) and
    chained while consecutive anchors sit on the same diagonal within
    ``max_gap``; chains spanning >= min_block become rows. Both
    orientations are scanned; reverse hits report descending query
    coordinates (the nucmer inversion convention that encircle.py keys
    on). Rows are sorted by (q_name asc, q_start asc) like
    ``show-coords -Tq`` (Snakefile:92)."""
    import numpy as np
    t_vals, t_pos = target_index(t_seq, k)
    rows: List[CoordRow] = []
    qlen, tlen = len(q_seq), len(t_seq)
    for rc in (False, True):
        q = _revcomp_str(q_seq) if rc else q_seq
        qp, rp = anchor_hits(t_vals, t_pos, q, k)
        if len(qp) == 0:
            continue
        diag = rp - qp
        order = np.lexsort((qp, diag))
        qp, rp, diag = qp[order], rp[order], diag[order]
        brk = np.flatnonzero((np.diff(diag) != 0)
                             | (np.diff(qp) > max_gap)) + 1
        for lo, hi in zip(np.concatenate([[0], brk]),
                          np.concatenate([brk, [len(qp)]])):
            q0, q1 = int(qp[lo]), int(qp[hi - 1])
            r0, r1 = int(rp[lo]), int(rp[hi - 1])
            if q1 + k - q0 < min_block:
                continue
            if rc:  # back to original query coordinates, descending
                qs, qe = qlen - q0, qlen - (q1 + k) + 1
            else:
                qs, qe = q0 + 1, q1 + k
            rows.append(CoordRow(r0 + 1, r1 + k, qs, qe, tlen, qlen,
                                 t_name, q_name))
    rows.sort(key=lambda r: (r.q_name, min(r.q_start, r.q_end)))
    return rows


def terminal_read_names(t_seq: str, reads, window: int = 50_000,
                        k: int = 21, min_anchors: int = 8) -> List[str]:
    """Names of reads anchored in the first/last ``window`` bases of
    t_seq (Lathe circularize_bam2reads, Snakefile:36-49: samtools view of
    the two terminal regions). ``reads`` yields (name, seq); either
    orientation counts."""
    termini = t_seq[:window] + ("N" * 64) + t_seq[-window:]
    t_vals, t_pos = target_index(termini, k)
    out = []
    for name, seq in reads:
        hits = 0
        for rc in (False, True):
            q = _revcomp_str(seq) if rc else seq
            qp, _rp = anchor_hits(t_vals, t_pos, q, k)
            hits = max(hits, len(qp))
        if hits >= min_anchors:
            out.append(name)
    return out
