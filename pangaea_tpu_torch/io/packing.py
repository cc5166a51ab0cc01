"""Packing reads into fixed-shape code batches for the device kernels.

Copied from pangaea_tpu.io.packing (the group packer and its
quality plane). Reads become rows of a dense (R, L) uint8 code matrix (A=0,C=1,T=2,G=3, 4=N/pad) with

- ``lengths``: per-row read length,
- ``seg_ids``: per-row barcode-group index (-1 for dropped groups/padding),
- ``cont``: 1 for continuation rows of reads longer than L, which repeat
  the previous row's last ``overlap`` bases so no k-mer window is lost or
  double-counted (see kernels/encode.kmer_window_values),
- ``lowq`` (quality-masked paired input only): (R, L) uint8, 1 where a
  base's quality is below ``min_qual_char``.

Because the reference scans each barcode's reads as one concatenated
N-separated string, per-read windows are exactly equivalent: k-mers never
span reads. The last batch of a chunk is padded with seg_id=-1 /
length=0 rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from pangaea_tpu_torch.io.grouping import ReadPair, group_kept
from pangaea_tpu_torch.kernels.encode import encode_bases


@dataclass
class PackedBatch:
    codes: np.ndarray     # (R, L) uint8
    lengths: np.ndarray   # (R,) int32
    seg_ids: np.ndarray   # (R,) int32, -1 = dropped/padding
    cont: np.ndarray      # (R,) uint8
    # rows actually filled (trailing rows are all padding); recorded at
    # pack time so the sort-join can trim every tail batch's pad-row
    # windows (pure sentinel sort cost) without scanning lengths
    rows_used: int = -1
    # (R, L) uint8, nonzero where base quality < min_qual_char; present
    # only on the quality-masked paired sort-join path (the weighted
    # global join, kernels/features.py batch_kmer_keys_weighted)
    lowq: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.rows_used < 0:
            self.rows_used = self.codes.shape[0]


def _split_ranges(n: int, max_len: int, overlap: int
                  ) -> List[Tuple[int, int, int]]:
    """(start, end, is_continuation) row ranges of an n-base read."""
    if n <= max_len:
        return [(0, n, 0)]
    ranges = []
    step = max_len - overlap
    start = 0
    first = True
    while start < n:
        end = min(start + max_len, n)
        if not first and end - start <= overlap:
            break  # fully contained in the previous row
        ranges.append((start, end, 0 if first else 1))
        if start + max_len >= n:
            break
        start += step
        first = False
    return ranges


def _split_rows(codes: np.ndarray, max_len: int, overlap: int
                ) -> List[Tuple[np.ndarray, int]]:
    """Split an encoded read into (row_codes, is_continuation) rows."""
    return [(codes[s:e], c)
            for s, e, c in _split_ranges(len(codes), max_len, overlap)]


class _BatchBuilder:
    def __init__(self, rows_per_batch: int, max_len: int,
                 with_lowq: bool = False):
        self.R, self.L = rows_per_batch, max_len
        self.with_lowq = with_lowq
        self._reset()

    def _reset(self):
        self.codes = np.full((self.R, self.L), 4, dtype=np.uint8)
        self.lengths = np.zeros(self.R, dtype=np.int32)
        self.seg_ids = np.full(self.R, -1, dtype=np.int32)
        self.cont = np.zeros(self.R, dtype=np.uint8)
        self.lowq = (np.zeros((self.R, self.L), dtype=np.uint8)
                     if self.with_lowq else None)
        self.n = 0

    def add_row(self, row: np.ndarray, seg: int, is_cont: int,
                lowq_row: Optional[np.ndarray] = None
                ) -> Optional[PackedBatch]:
        out = None
        if self.n == self.R:
            out = self.flush()
        i = self.n
        self.codes[i, : len(row)] = row
        self.lengths[i] = len(row)
        self.seg_ids[i] = seg
        self.cont[i] = is_cont
        if self.lowq is not None and lowq_row is not None:
            self.lowq[i, : len(lowq_row)] = lowq_row
        self.n += 1
        return out

    def flush(self) -> Optional[PackedBatch]:
        if self.n == 0:
            return None
        b = PackedBatch(self.codes, self.lengths, self.seg_ids, self.cont,
                        rows_used=self.n, lowq=self.lowq)
        self._reset()
        return b


class GroupPacker:
    """Packs (barcode, pairs) groups into chunks of complete groups.

    Groups failing the reference filter (empty barcode or concatenated
    length <= min_len, count_kmer.cpp:62-63) are dropped entirely — their
    reads never reach the device. With ``keep_dropped=True`` their reads
    are emitted as seg_id=-1 rows instead (excluded from histograms but
    present in the stream), which the sort-join abundance path needs: the
    global k-mer counts must cover every read, like jellyfish over the
    whole file (src/feature.py:76-86).

    With ``min_qual_char`` set, batches carry a lowq plane (quality below
    that character) for the masked-global weighted sort-join (the
    paired-reads path, src/feature.py:76-86); the codes themselves stay
    UNMASKED — the group scan reads raw bases (count_kmer.cpp:87).
    """

    def __init__(self, min_len: int = 2000, max_read_len: int = 256,
                 overlap: int = 14, reads_per_batch: int = 65536,
                 groups_per_chunk: int = 8192, keep_dropped: bool = False,
                 min_qual_char: Optional[str] = None):
        self.min_len = min_len
        self.max_len = max_read_len
        self.overlap = overlap
        self.rows = reads_per_batch
        self.groups_per_chunk = groups_per_chunk
        self.keep_dropped = keep_dropped
        self.min_qual = ord(min_qual_char) if min_qual_char else None

    def iter_events(self, groups: Iterable[Tuple[str, List[ReadPair]]]
                    ) -> Iterator[Tuple[str, object]]:
        """Yields ``("batch", b)`` as soon as each fixed-size batch fills
        and ``("chunk", names)`` to close the chunk the preceding batches
        belong to."""
        names: List[str] = []
        bb = _BatchBuilder(self.rows, self.max_len,
                           with_lowq=self.min_qual is not None)

        def close_chunk():
            nonlocal names
            tail = bb.flush()
            if tail is not None:
                yield "batch", tail
            yield "chunk", names
            names = []

        def add_read(seq: str, qual: str, seg: int):
            codes = encode_bases(seq.encode("ascii"))
            lowq = None
            if self.min_qual is not None:
                q = np.frombuffer(qual.encode("ascii"), dtype=np.uint8)
                lowq = np.zeros(len(codes), np.uint8)
                m = min(len(q), len(codes))
                lowq[:m] = q[:m] < self.min_qual
            for s, e, is_cont in _split_ranges(len(codes), self.max_len,
                                               self.overlap):
                yield bb.add_row(codes[s:e], seg, is_cont,
                                 None if lowq is None else lowq[s:e])

        for barcode, group in groups:
            if not group_kept(barcode, group, self.min_len):
                if self.keep_dropped:
                    for p in group:
                        for seq, qual in ((p.seq1, p.qual1),
                                          (p.seq2, p.qual2)):
                            for out in add_read(seq, qual, -1):
                                if out is not None:
                                    yield "batch", out
                continue
            if len(names) == self.groups_per_chunk:
                yield from close_chunk()
            seg = len(names)
            names.append(barcode)
            for p in group:
                for seq, qual in ((p.seq1, p.qual1), (p.seq2, p.qual2)):
                    for out in add_read(seq, qual, seg):
                        if out is not None:
                            yield "batch", out
        if names or bb.n:
            yield from close_chunk()
