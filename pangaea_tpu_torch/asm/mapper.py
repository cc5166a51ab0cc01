"""Built-in k-mer vote mapper — the bwa stand-in of step 4, on the device.

Port of pangaea_tpu/asm/mapper.py. The reference maps reads back to
binned contigs with ``bwa mem`` only to derive per-contig depth and the
read pairs with no good alignment to high-coverage contigs
(bin_assembly.sh:33-45, extract_unmapped.cpp), plus contig-to-seed
containment in merge_olc.py:32-52. None of those need base-exact
alignments, so the built-in fallback votes with k-mers:

- index (:func:`index_batch`): a dense ``(4**k,)`` int32 table on the
  device (k=13: 256 MiB) maps a canonical k-mer to contig id + 1, filled
  by one ``scatter_reduce_(..., "amax")`` per packed batch. On a collision
  a per-k-mer hash coin (bit 15 of ``canon * 0x9E3779B9 mod 2**32``,
  computed in int64) picks the sign: positive entries keep the largest
  id, negative ones the smallest (max of negatives = min id), so a shared
  repeat's k-mers split about 50/50 between its copies. Invalid windows
  are left out of the scatter (an out-of-range index would be a device
  assert, not a drop).
- map (:func:`map_batch`): gather the table at every canonical window of
  a read batch, sort each row, and take the longest run of equal nonzero
  ids => (best contig, votes, valid windows) per row. The run starts come
  from the CUDA ``cummax`` (``kernels/scan.py``) over the flattened
  ``(R*W,)`` rows, with the global index ``r*W + c`` at each run start and
  INT32_MIN elsewhere: column 0 starts a run in every row and the global
  indices increase, so the flat running max is ``r*W`` plus the row-wise
  one, and the run length ``(r*W + c) - last + 1`` equals pangaea_tpu's
  ``col - last_boundary + 1`` (a row-wise ``lax.cummax``) bit for bit.

The records written (BAM, depth file) come from host code copied from
pangaea_tpu (:func:`map_pairs_to_bam`, :func:`write_depth_file`); only the
three per-row arrays come back from the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from pangaea_tpu_torch.io.bam import (_NT16_LUT, BamRecord, BamWriter,
                                      FPAIRED, FREAD1, FREAD2, FUNMAP)
from pangaea_tpu_torch.io.packing import _BatchBuilder, _split_rows
from pangaea_tpu_torch.kernels import scan
from pangaea_tpu_torch.kernels.encode import (canonical_kmers, encode_bases,
                                              kmer_window_values)
from pangaea_tpu_torch.utils import DeviceLike, resolve_device

DEFAULT_K = 13
# empty-table sentinel: below every signed-magnitude entry
_EMPTY = -(2 ** 31)
_COIN_MULT = 0x9E3779B9


def _iter_packed(seqs: Iterator[Tuple[str, int]], max_len: int, overlap: int,
                 rows: int):
    bb = _BatchBuilder(rows, max_len)
    for seq, seg in seqs:
        codes = encode_bases(seq.encode("ascii"))
        for row, is_cont in _split_rows(codes, max_len, overlap):
            out = bb.add_row(row, seg, is_cont)
            if out is not None:
                yield out
    out = bb.flush()
    if out is not None:
        yield out


def index_batch(table: torch.Tensor, codes: torch.Tensor,
                lengths: torch.Tensor, seg_ids: torch.Tensor,
                cont: torch.Tensor, *, k: int, overlap: int) -> None:
    """Scatter-max one packed contig batch into ``table`` in place."""
    skip = cont.to(torch.int32) * max(0, overlap - (k - 1))
    vals, valid = kmer_window_values(codes, lengths, k, win_skip=skip)
    canon = canonical_kmers(vals, k)
    keep = valid & (seg_ids[:, None] >= 0)
    idx = canon[keep].to(torch.int64)
    mag = (seg_ids[:, None] + 1).expand_as(canon)[keep]
    coin = ((idx * _COIN_MULT) >> 15) & 1
    val = torch.where(coin == 1, mag, -mag)
    table.scatter_reduce_(0, idx, val, "amax", include_self=True)


def sorted_row_ids(table: torch.Tensor, codes: torch.Tensor,
                   lengths: torch.Tensor, *, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, W) contig ids + 1 of every window, sorted per row (0 = no
    contig), and the (R, W) window validity."""
    vals, valid = kmer_window_values(codes, lengths, k)
    canon = canonical_kmers(vals, k)
    ent = table[canon.to(torch.int64)]
    ids = torch.where(valid & (ent != _EMPTY), ent.abs(),
                      torch.zeros_like(ent))
    return torch.sort(ids, dim=1).values, valid


def run_boundaries(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(global index r*W + c, the same at each run start of the sorted
    rows ``s`` and INT32_MIN elsewhere), both (R, W) int32."""
    R, W = s.shape
    if R * W >= 2 ** 31:
        raise ValueError(f"map batch of {R} x {W} windows exceeds int32")
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[:, 1:] = s[:, 1:] != s[:, :-1]
    glob = torch.arange(R * W, dtype=torch.int32,
                        device=s.device).view(R, W)
    return glob, torch.where(
        is_new, glob, torch.full_like(glob, torch.iinfo(torch.int32).min))


def map_batch(table: torch.Tensor, codes: torch.Tensor,
              lengths: torch.Tensor, *, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best contig or -1, votes, valid windows) per row, int32."""
    s, valid = sorted_row_ids(table, codes, lengths, k=k)
    R, W = s.shape
    glob, boundary = run_boundaries(s)
    last = scan.cummax(boundary.view(-1)).view(R, W)
    runlen = torch.where(s > 0, glob - last + 1, torch.zeros_like(glob))
    votes = runlen.max(dim=1).values
    best = s.gather(1, runlen.argmax(dim=1, keepdim=True))[:, 0] - 1
    nvalid = valid.sum(dim=1, dtype=torch.int32)
    return best, votes, nvalid


class KmerMapper:
    """Contig k-mer index on ``device`` (``cuda`` unless the caller asks
    for another; no card raises) and the vote mapper over it."""

    def __init__(self, k: int = DEFAULT_K, max_row_len: int = 1024,
                 rows_per_batch: int = 4096, device: DeviceLike = None):
        self.k = k
        self.max_row_len = max_row_len
        self.rows = rows_per_batch
        self.device = resolve_device(device)
        self.table = None
        self.contig_names: List[str] = []
        self.contig_lengths: List[int] = []

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def index_contigs(self, contigs: Sequence[Tuple[str, str]]) -> None:
        """contigs: [(name, seq), ...]"""
        self.contig_names = [c[0].split()[0] for c in contigs]
        self.contig_lengths = [len(c[1]) for c in contigs]
        self.table = torch.full((4 ** self.k,), _EMPTY, dtype=torch.int32,
                                device=self.device)
        seqs = ((seq, i) for i, (_, seq) in enumerate(contigs))
        for b in _iter_packed(seqs, self.max_row_len, self.k - 1, self.rows):
            index_batch(self.table, self._upload(b.codes),
                        self._upload(b.lengths), self._upload(b.seg_ids),
                        self._upload(b.cont), k=self.k, overlap=self.k - 1)

    def encode_reads(self, seqs: List[str]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, L) codes and (R,) lengths of a read batch on the device.
        Reads longer than max_row_len are truncated for mapping (linked
        short reads are ~150 bp). Row width quantizes to 128 at the
        batch's longest read instead of always max_row_len."""
        R = len(seqs)
        mx = max((len(s) for s in seqs), default=1)
        L = min(self.max_row_len, -(-max(mx, 1) // 128) * 128)
        codes = np.full((R, L), 4, np.uint8)
        lengths = np.zeros(R, np.int32)
        for i, s in enumerate(seqs):
            c = encode_bases(s.encode("ascii"))[:L]
            codes[i, :len(c)] = c
            lengths[i] = len(c)
        return self._upload(codes), self._upload(lengths)

    def map_reads(self, seqs: List[str]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (contig_idx or -1, votes, n_windows) per sequence."""
        if not seqs:
            empty = np.zeros(0, np.int32)
            return empty, empty.copy(), empty.copy()
        out = map_batch(self.table, *self.encode_reads(seqs), k=self.k)
        best, votes, nvalid = (t.cpu().numpy() for t in out)
        return best, votes, nvalid


def map_pairs_to_bam(mapper: KmerMapper, pair_iter, bam_path: str,
                     min_vote_frac: float = 0.5,
                     batch_pairs: int = 32768) -> Dict[int, float]:
    """Map read pairs, write BAM records, accumulate per-contig depth.

    Returns {contig_idx: total_bases_mapped} (depth = bases / length).
    A mate maps when votes >= min_vote_frac * windows; its NM tag
    estimates base-level mismatches as missing windows / k (one
    substitution kills up to k windows), which is what bwa's NM counts
    and what extract_unmapped's identity filter ((cols - NM)/cols >= 0.95,
    extract_unmapped.cpp:107-113) expects. Copied from pangaea_tpu.
    """
    depth_bases: Dict[int, float] = {}
    writer = BamWriter(bam_path, mapper.contig_names,
                       mapper.contig_lengths)
    batch: List = []

    def flush():
        if not batch:
            return
        seqs = []
        quals = []
        for name, s1, q1, s2, q2 in batch:
            seqs += [s1, s2]
            quals += [q1, q2]
        best, votes, nvalid = mapper.map_reads(seqs)
        # bulk seq/qual encode: when the batch is uniform-length the nt16
        # nibble packing and phred offset run as one numpy pass over the
        # whole batch and BamWriter.write receives ready slices
        seq_b = qual_b = None
        L = len(seqs[0])
        if L % 2 == 0 and all(len(s) == L for s in seqs):
            nib = _NT16_LUT[np.frombuffer("".join(seqs).encode("ascii"),
                                          np.uint8)].reshape(-1, L)
            packed = ((nib[:, 0::2] << 4) | nib[:, 1::2]).tobytes()
            half = L // 2
            seq_b = [packed[i * half:(i + 1) * half]
                     for i in range(len(seqs))]
            qraw = (np.frombuffer("".join(quals).encode("ascii"),
                                  np.uint8) - np.uint8(33)).tobytes()
            qual_b = [qraw[i * L:(i + 1) * L] for i in range(len(quals))]
        for j, (name, s1, q1, s2, q2) in enumerate(batch):
            for mate, (seq, qual) in enumerate(((s1, q1), (s2, q2))):
                i = 2 * j + mate
                matched = (best[i] >= 0 and nvalid[i] > 0
                           and votes[i] >= min_vote_frac * nvalid[i])
                flag = FPAIRED | (FREAD1 if mate == 0 else FREAD2)
                if matched:
                    tid = int(best[i])
                    miss_frac = 1.0 - votes[i] / max(int(nvalid[i]), 1)
                    nm = int(round(miss_frac * len(seq) / mapper.k))
                    rec = BamRecord(name, flag, tid, 0, 60,
                                    [("M", len(seq))], seq, qual,
                                    {"NM": nm})
                    depth_bases[tid] = depth_bases.get(tid, 0.0) + len(seq)
                else:
                    rec = BamRecord(name, flag | FUNMAP, -1, -1, 0, [],
                                    seq, qual, {})
                writer.write(rec,
                             seq_bytes=None if seq_b is None else seq_b[i],
                             qual_bytes=None if qual_b is None
                             else qual_b[i])
        batch.clear()

    for pair in pair_iter:
        batch.append(pair)
        if len(batch) >= batch_pairs:
            flush()
    flush()
    writer.close()
    return depth_bases


def write_depth_file(path: str, names: Sequence[str],
                     lengths: Sequence[int],
                     depth_bases: Dict[int, float]) -> None:
    """jgi_summarize_bam_contig_depths-compatible columns
    (extract_unmapped.cpp:155-170 reads name, len, totalAvgDepth)."""
    with open(path, "w") as f:
        f.write("contigName\tcontigLen\ttotalAvgDepth\n")
        for i, (name, ln) in enumerate(zip(names, lengths)):
            d = depth_bases.get(i, 0.0) / max(ln, 1)
            f.write(f"{name}\t{ln}\t{d:.4f}\n")
