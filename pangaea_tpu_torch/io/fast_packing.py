"""Fast host path: native C++ FASTQ reader + vectorized numpy grouping.

Copied from pangaea_tpu.io.fast_packing: the group-event streams, and
``native_seq_batches``, the dense-table paths' global pass over every
read. The group streams produce the same
("batch", PackedBatch) / ("chunk", names) event stream as
io/packing.GroupPacker — the pure-Python version, kept as the behavioral
oracle — with the hot loops in C++ (gzip + parse + encode, native/) and
numpy (barcode grouping as cumsum/searchsorted over byte arrays).

Grouping math (replicating iter_barcode_groups bug_compat=True, i.e. the
reference's boundary leak — see io/grouping.py):

  changes[j] = B[j] != B[j-1]  (B[-1] = "")
  pair j joins the flush at the first change position >= j (or the final
  flush) => group_id(j) = searchsorted(change_positions, j)
  group names = [""] + B[change_positions]  (flush g emits the barcode
  seen *before* it; the final flush emits the last barcode)

Restriction: reads longer than the row width raise OverlongReadError
(the reader truncates their codes); the feature extractor then retries
once at ``max_read_len``. The Python packer splits such reads instead.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pangaea_tpu_torch.io.packing import PackedBatch
from pangaea_tpu_torch.io.prefetch import prefetch
from pangaea_tpu_torch.native import NativeFastqReader


class OverlongReadError(RuntimeError):
    """A read longer than the row width reached the native stream."""


def native_seq_batches(paths: List[str], max_read_len: int,
                       reads_per_batch: int,
                       min_qual_char: Optional[str] = None
                       ) -> Iterator[PackedBatch]:
    """Global-pass batches: every read of ``paths`` in file order, no
    grouping (seg_ids and cont all 0), the last batch of each file padded
    with length-0 rows. With ``min_qual_char`` the reader masks bases of
    lower quality to code 4 (jellyfish --min-qual-char)."""
    zero_cont = np.zeros(reads_per_batch, np.uint8)
    zero_seg = np.zeros(reads_per_batch, np.int32)
    for path in paths:
        with NativeFastqReader(path, max_len=max_read_len,
                               min_qual_char=min_qual_char) as rd:
            while True:
                out = rd.read(reads_per_batch)
                if out is None:
                    break
                codes, lengths, _ = out
                if int(lengths.max(initial=0)) > max_read_len:
                    raise _overlong(max_read_len)
                n = len(lengths)
                if n < reads_per_batch:
                    pad_c = np.full((reads_per_batch, max_read_len), 4,
                                    np.uint8)
                    pad_c[:n] = codes
                    pad_l = np.zeros(reads_per_batch, np.int32)
                    pad_l[:n] = lengths
                    codes, lengths = pad_c, pad_l
                yield PackedBatch(codes, lengths, zero_seg, zero_cont)


def _group_pairs(bcs: np.ndarray, prev_last: bytes
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(group_id per pair, change_positions, names array incl. leading '')

    bcs: (P,) bytes array of per-pair barcodes; prev_last: the running
    last_barcode from the previous buffer ("" at stream start).
    """
    P = len(bcs)
    prev = np.concatenate([np.array([prev_last], dtype=bcs.dtype),
                           bcs[:-1]])
    changes = bcs != prev
    pos = np.flatnonzero(changes)
    gid = np.searchsorted(pos, np.arange(P), side="left")
    return gid, pos, bcs[pos] if len(pos) else bcs[:0]


def _group_event_core(buffers, min_len: int, max_read_len: int,
                      reads_per_batch: int, groups_per_chunk: int,
                      keep_dropped: bool) -> Iterator[tuple]:
    """Shared chunk-assembly state machine behind the native group-event
    streams. ``buffers`` yields ``(codes, lengths, bcs, lowq, extra)``:
    interleaved COMPLETE pairs — codes (2P, L), lengths (2P,), bcs (P,)
    per-pair barcodes, ``lowq`` an optional (2P, L) quality-mask plane,
    and ``extra`` optional (codes, lengths, lowq) of reads that count
    only globally (trailing unpaired records, mismatched R1/R2 pairs).
    Open groups carry across buffers; the final buffer flushes."""
    R = reads_per_batch

    # carry state across buffers (open group at a buffer boundary)
    last_barcode = b""  # the reference's running last_barcode

    # chunk assembly state
    chunk_names: List[str] = []
    row_codes: List[np.ndarray] = []
    row_lengths: List[np.ndarray] = []
    row_segs: List[np.ndarray] = []
    row_lowq: List[Optional[np.ndarray]] = []
    with_lowq = False
    nrows = 0

    def add_rows(codes, lengths, segs, lowq=None) -> None:
        nonlocal nrows, with_lowq
        if len(lengths) == 0:
            return
        row_codes.append(codes)
        row_lengths.append(lengths)
        row_segs.append(segs)
        row_lowq.append(lowq)
        if lowq is not None:
            with_lowq = True
        nrows += len(lengths)

    def _cat_lowq():
        if not with_lowq:
            return None
        return np.concatenate(
            [lq if lq is not None
             else np.zeros_like(row_codes[i])
             for i, lq in enumerate(row_lowq)])

    def drain_rows(final: bool) -> List[PackedBatch]:
        """Pack accumulated rows into fixed-size PackedBatches; keeps the
        sub-batch remainder unless ``final`` (then pads it)."""
        nonlocal row_codes, row_lengths, row_segs, row_lowq, nrows
        if nrows == 0 or (nrows < R and not final):
            return []
        codes = np.concatenate(row_codes)
        lengths = np.concatenate(row_lengths)
        segs = np.concatenate(row_segs)
        lowq = _cat_lowq()
        row_codes, row_lengths, row_segs, row_lowq = [], [], [], []
        nrows = 0
        out = []
        full_end = (len(lengths) // R) * R
        for start in range(0, full_end, R):
            out.append(PackedBatch(
                codes[start:start + R], lengths[start:start + R],
                segs[start:start + R], np.zeros(R, np.uint8),
                lowq=None if lowq is None else lowq[start:start + R]))
        rest = len(lengths) - full_end
        if rest:
            if final:
                bc = np.full((R, max_read_len), 4, np.uint8)
                bc[:rest] = codes[full_end:]
                bl = np.zeros(R, np.int32)
                bl[:rest] = lengths[full_end:]
                bs = np.full(R, -1, np.int32)
                bs[:rest] = segs[full_end:]
                blq = None
                if lowq is not None:
                    blq = np.zeros((R, max_read_len), np.uint8)
                    blq[:rest] = lowq[full_end:]
                out.append(PackedBatch(bc, bl, bs, np.zeros(R, np.uint8),
                                       rows_used=rest, lowq=blq))
            else:
                add_rows(codes[full_end:], lengths[full_end:],
                         segs[full_end:],
                         None if lowq is None else lowq[full_end:])
        return out

    def close_chunk():
        nonlocal chunk_names
        for b in drain_rows(final=True):
            yield "batch", b
        yield "chunk", chunk_names
        chunk_names = []

    def emit_groups(codes, lengths, bcs, lowq, final: bool):
        """Process complete pairs; returns leftover tail (open group)."""
        nonlocal last_barcode
        if len(bcs) == 0:
            return None
        gid, pos, flush_names = _group_pairs(bcs, last_barcode)
        if not final:
            if len(pos) == 0:
                return codes, lengths, bcs, lowq  # no flush possible yet
            # pairs at/after the last change belong to open groups
            cut = pos[-1]
            # groups 0..len(pos)-1 are NOT all closed: the group flushed
            # at pos[-1] is closed, but pairs AFTER pos[-1] are open.
            complete_pairs = cut + 1
            open_tail = (codes[2 * complete_pairs:],
                         lengths[2 * complete_pairs:],
                         bcs[complete_pairs:],
                         None if lowq is None
                         else lowq[2 * complete_pairs:])
            codes = codes[:2 * complete_pairs]
            lengths = lengths[:2 * complete_pairs]
            if lowq is not None:
                lowq = lowq[:2 * complete_pairs]
            bcs = bcs[:complete_pairs]
            gid = gid[:complete_pairs]
            n_groups = len(pos)
            names = np.concatenate([[last_barcode], flush_names[:-1]])
            last_barcode = bytes(flush_names[-1])
        else:
            open_tail = None
            n_groups = len(pos) + 1
            names = np.concatenate([[last_barcode], flush_names]) \
                if len(pos) else np.array([last_barcode], dtype=bcs.dtype if len(bcs) else object)
            if len(bcs):
                last_barcode = bytes(bcs[-1])

        if len(bcs):
            # group filter: barcode nonempty & concat length > min_len
            # (count_kmer.cpp:62-63; concat len = sum(len+1) per read)
            pair_contrib = (lengths[0::2].astype(np.int64)
                            + lengths[1::2] + 2)
            glen = np.zeros(n_groups, np.int64)
            np.add.at(glen, gid, pair_contrib)
            names = np.asarray(names)
            nonempty = np.array([len(x) > 0 for x in names])
            kept = nonempty & (glen > min_len)
            if keep_dropped:
                drop_rows = np.repeat(~kept[gid], 2)
                if drop_rows.any():
                    add_rows(codes[drop_rows], lengths[drop_rows],
                             np.full(int(drop_rows.sum()), -1, np.int32),
                             None if lowq is None else lowq[drop_rows])
            # assign chunk-local ids slice-wise so a chunk never mixes
            # ids from two chunks when it fills mid-buffer
            kept_idx = np.flatnonzero(kept)
            i = 0
            while i < len(kept_idx):
                space = groups_per_chunk - len(chunk_names)
                take = kept_idx[i:i + space]
                local = np.full(n_groups, -1, np.int32)
                local[take] = len(chunk_names) + np.arange(len(take),
                                                           dtype=np.int32)
                chunk_names.extend(names[g].decode() for g in take)
                pair_seg = local[gid]
                read_seg = np.repeat(pair_seg, 2)
                keep_rows = read_seg >= 0
                if keep_rows.any():
                    add_rows(codes[keep_rows], lengths[keep_rows],
                             read_seg[keep_rows],
                             None if lowq is None else lowq[keep_rows])
                i += len(take)
                if len(chunk_names) == groups_per_chunk:
                    yield from close_chunk()
        return open_tail

    # The carry (an open group at a buffer boundary) is kept as a LIST
    # of buffer fragments and only concatenated when the group finally
    # closes: one barcode run spanning many buffers — the unbarcoded
    # '~~~' tail of a real dataset is 10-20% of all pairs and sorts
    # last — would otherwise be re-concatenated and re-scanned every
    # buffer (O(run^2 / buffer) host work).
    carry_parts: list = []  # [(codes, lengths, bcs, lowq)]
    carry_bc = None         # the single barcode all carried pairs share

    def pop_carry(codes, lengths, bcs, lowq):
        nonlocal carry_parts, carry_bc
        if not carry_parts:
            return codes, lengths, bcs, lowq
        parts = carry_parts + [(codes, lengths, bcs, lowq)]
        carry_parts, carry_bc = [], None
        out_codes = np.concatenate([p[0] for p in parts])
        out_lengths = np.concatenate([p[1] for p in parts])
        out_bcs = np.concatenate([p[2] for p in parts])
        out_lowq = None
        if any(p[3] is not None for p in parts):
            out_lowq = np.concatenate(
                [p[3] if p[3] is not None else np.zeros_like(p[0])
                 for p in parts])
        return out_codes, out_lengths, out_bcs, out_lowq

    for codes, lengths, bcs, lowq, extra in buffers:
        final = codes is None
        if final:
            codes = np.zeros((0, max_read_len), np.uint8)
            lengths = np.zeros(0, np.int32)
            bcs = np.array([], dtype="S48")
            lowq = None
        if extra is not None and keep_dropped:
            xc, xl, xlq = extra
            add_rows(xc, xl, np.full(len(xl), -1, np.int32), xlq)
        if (not final and carry_parts and len(bcs)
                and (bcs == carry_bc).all()):
            # whole buffer continues the carried group: defer the
            # concatenation (O(1) append instead of a rescan)
            carry_parts.append((codes, lengths, bcs, lowq))
            continue
        codes, lengths, bcs, lowq = pop_carry(codes, lengths, bcs, lowq)

        tail = yield from emit_groups(codes, lengths, bcs, lowq, final)
        # eager emission: every complete batch ships now, so the consumer
        # pipeline overlaps device uploads with the next buffer's parse
        for b in drain_rows(final=False):
            yield "batch", b
        if final:
            break
        if tail is not None:
            carry_parts = [tail]
            # the open group's pairs all share the last barcode by
            # construction (they sit after the final change position)
            carry_bc = tail[2][-1] if len(tail[2]) else None
    if chunk_names or nrows:
        yield from close_chunk()


def _overlong(max_read_len: int):
    return OverlongReadError(
        f"read longer than max_read_len={max_read_len}; raise "
        "FeatureConfig.max_read_len to cover the longest read, or "
        "disable native IO (the python GroupPacker splits overlong "
        "reads across rows)")


def native_group_events(interleaved: str, min_len: int, max_read_len: int,
                        reads_per_batch: int, groups_per_chunk: int = 8192,
                        pairs_per_buffer: int = 32768,
                        keep_dropped: bool = False
                        ) -> Iterator[tuple]:
    """("batch", PackedBatch) / ("chunk", names) event stream equivalent
    to GroupPacker.iter_events(iter_barcode_groups(
    iter_read_pairs_interleaved(path))).

    Batches are emitted as soon as they fill (consumers pipeline parse ->
    upload -> dispatch at batch granularity; the old whole-chunk
    materialization stalled the device for the full host parse);
    a "chunk" event closes the chunk the preceding batches belong to.

    keep_dropped=True emits filtered groups' reads as seg_id=-1 rows (for
    the sort-join path's jellyfish-equivalent global counts; see
    io/packing.GroupPacker)."""
    rd = NativeFastqReader(interleaved, max_len=max_read_len)

    def buffers():
        try:
            while True:
                out = rd.read(2 * pairs_per_buffer)
                if out is None:
                    yield None, None, None, None, None
                    return
                codes, lengths, bcs = out
                # overlong check covers the WHOLE buffer, including the
                # trailing unpaired record split off below: global-only
                # reads truncate silently otherwise
                if int(lengths.max(initial=0)) > max_read_len:
                    raise _overlong(max_read_len)
                extra = None
                if len(lengths) % 2:  # trailing unpaired record: drop
                    # ... but it still counts globally
                    extra = (codes[-1:], lengths[-1:], None)
                    codes, lengths, bcs = (codes[:-1], lengths[:-1],
                                           bcs[:-1])
                # per-pair barcode = R1's (interleaved)
                yield codes, lengths, bcs[0::2], None, extra
        finally:
            rd.close()

    # the reader (C inflate+parse+encode, GIL released) gets its own
    # thread so it overlaps the numpy grouping/packing — without this
    # the whole host chain (read -> group -> pack -> upload) serializes
    # on the single event-stream worker
    yield from _group_event_core(prefetch(buffers(), depth=2), min_len,
                                 max_read_len, reads_per_batch,
                                 groups_per_chunk, keep_dropped)


def native_group_events_paired(reads1: str, reads2: str, min_len: int,
                               max_read_len: int, reads_per_batch: int,
                               groups_per_chunk: int = 8192,
                               pairs_per_buffer: int = 32768,
                               keep_dropped: bool = False,
                               min_qual_char: Optional[str] = None
                               ) -> Iterator[tuple]:
    """Paired (-1/-2) twin of :func:`native_group_events`: two lockstep
    readers; R1/R2 name- or barcode-mismatched pairs are skipped from
    grouping (count_kmer.cpp:195-197) but kept as global-only reads
    (jellyfish counts the raw files); with ``min_qual_char`` each batch
    carries the lowq plane for the weighted masked global join
    (kernels/features.py §quality-masked)."""
    with_lowq = min_qual_char is not None

    def open_reader(path):
        return NativeFastqReader(path, max_len=max_read_len,
                                 min_qual_char=min_qual_char,
                                 barcode_width=48, name_width=64,
                                 with_lowq=with_lowq)

    rd1 = open_reader(reads1)
    rd2 = open_reader(reads2)

    def unpack(out):
        if out is None:
            return None
        if with_lowq:
            codes, lengths, bcs, names, lowq = out
        else:
            codes, lengths, bcs, names = out
            lowq = None
        return codes, lengths, bcs, names, lowq

    # the two files inflate+parse+encode CONCURRENTLY (ctypes releases
    # the GIL)
    pool = ThreadPoolExecutor(2)

    def buffers():
        try:
            done = False
            while not done:
                f1 = pool.submit(rd1.read, pairs_per_buffer)
                f2 = pool.submit(rd2.read, pairs_per_buffer)
                o1 = unpack(f1.result())
                o2 = unpack(f2.result())
                if o1 is None and o2 is None:
                    yield None, None, None, None, None
                    return
                # overlong check covers the FULL buffers (leftover tails
                # become global-only reads below and must not truncate
                # silently)
                for o in (o1, o2):
                    if o is not None and \
                            int(o[1].max(initial=0)) > max_read_len:
                        raise _overlong(max_read_len)
                # unequal file lengths: leftover reads are global-only
                extras = []
                if o1 is None or o2 is None or o1[1].shape != o2[1].shape:
                    n1 = 0 if o1 is None else len(o1[1])
                    n2 = 0 if o2 is None else len(o2[1])
                    p = min(n1, n2)
                    long_o = o1 if n1 > n2 else o2
                    if long_o is not None and max(n1, n2) > p:
                        extras.append((long_o[0][p:], long_o[1][p:],
                                       None if long_o[4] is None
                                       else long_o[4][p:]))
                    if p == 0:
                        for x in extras:
                            yield (np.zeros((0, max_read_len), np.uint8),
                                   np.zeros(0, np.int32),
                                   np.array([], dtype="S48"), None, x)
                        continue
                    o1 = tuple(a[:p] if a is not None else None
                               for a in o1) if o1 else None
                    o2 = tuple(a[:p] if a is not None else None
                               for a in o2) if o2 else None
                c1, l1, b1, nm1, q1 = o1
                c2, l2, b2, nm2, q2 = o2
                P = len(l1)
                ok = (nm1 == nm2) & (b1 == b2)
                # interleave R1/R2 rows
                codes = np.empty((2 * P, max_read_len), np.uint8)
                codes[0::2] = c1
                codes[1::2] = c2
                lengths = np.empty(2 * P, np.int32)
                lengths[0::2] = l1
                lengths[1::2] = l2
                lowq = None
                if with_lowq:
                    lowq = np.empty((2 * P, max_read_len), np.uint8)
                    lowq[0::2] = q1
                    lowq[1::2] = q2
                if not ok.all():
                    # mismatched pairs: global-only (both mates)
                    bad = np.repeat(~ok, 2)
                    extras.append((codes[bad], lengths[bad],
                                   None if lowq is None else lowq[bad]))
                    good = np.repeat(ok, 2)
                    codes, lengths = codes[good], lengths[good]
                    if lowq is not None:
                        lowq = lowq[good]
                    b1 = b1[ok]
                extra = None
                if extras:
                    extra = (np.concatenate([x[0] for x in extras]),
                             np.concatenate([x[1] for x in extras]),
                             (np.concatenate([x[2] for x in extras])
                              if with_lowq else None))
                yield codes, lengths, b1, lowq, extra
        finally:
            # wait=True: on an error path f2 may still be mid-read inside
            # rd2.read; closing the C Reader under it would be a
            # use-after-free. In-flight work is one bounded buffer read.
            pool.shutdown(wait=True)
            rd1.close()
            rd2.close()

    yield from _group_event_core(prefetch(buffers(), depth=2), min_len,
                                 max_read_len, reads_per_batch,
                                 groups_per_chunk, keep_dropped)
