"""2-bit nucleotide encoding and canonical k-mer math (k <= 31).

Port of pangaea_tpu/kernels/encode.py. Behavior contract (reference
count_kmer.cpp / count_tnf.cpp):

- base code = ``(ascii >> 1) & 3`` for A/C/G/T (count_kmer.cpp:81), i.e.
  A=0, C=1, T=2, G=3. Any other character resets the rolling k-mer
  (count_kmer.cpp:73-78). Code 4 marks "invalid" (N / pad).
- k-mer value = big-endian base-4 integer of the codes (count_kmer.cpp:79-82).
- reverse complement = reverse the 2-bit groups and XOR 0b10 into each
  (count_kmer.cpp:11-21); with this code table complement(x) = x ^ 2.
- canonical k-mer = min(value, revcomp(value)) (count_kmer.cpp:86).

- k <= 15 values are int32; 16 <= k <= 31 values are int64, the 2k-bit
  value itself (the reference's uint64, count_kmer.cpp:79-86), where
  pangaea_tpu carries a split (hi, lo) uint32 pair. Every int64 value
  stays below 2^62, so torch's arithmetic right shift never sees a sign.

Device functions take and return torch tensors on any device; the host
helpers (``encode_bases``, ``decode_kmers``, ``kmer_positions_np``,
``canonical_order``, ``canonical_rank_lut``, ``num_canonical_kmers``)
are numpy.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

# Host-side ASCII -> code lookup (uint8). 4 = invalid.
_ENC_LUT = np.full(256, 4, dtype=np.uint8)
for _b in b"ACGT":
    _ENC_LUT[_b] = (_b >> 1) & 3
INVALID_CODE = np.uint8(4)

_MASK32 = 0xFFFFFFFF


def encode_bases(seq: bytes | np.ndarray) -> np.ndarray:
    """Encode an ASCII sequence to uint8 codes (A=0,C=1,T=2,G=3, else 4)."""
    if isinstance(seq, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(seq, dtype=np.uint8)
    else:
        arr = np.asarray(seq, dtype=np.uint8)
    return _ENC_LUT[arr]


def revcomp_kmers(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mer values, k <= 31.

    k <= 16: the 32-bit bit-twiddle of count_kmer.cpp:11-21 (reverse all
    2-bit groups of the word, complement every group, shift the k
    meaningful groups down), computed in int64 and masked to 32 bits:
    torch's uint32 op coverage is partial and its int32 right shift is
    arithmetic.

    16 < k <= 31 (int64 values): rc(A.B) = rc(B).rc(A) for the first k-16
    bases A (the high word) and the last 16 bases B (the low 32 bits), as
    pangaea_tpu's revcomp_kmers_pair builds it: ``rc16(lo) << 2(k-16) |
    rc_{k-16}(hi)``. Both parts are 32-bit twiddles and the result stays
    below 2^62, so no step needs a 64-bit constant or a 64-bit bit
    reverse through the sign bit."""
    if k > 16:
        assert k <= 31, f"k={k}: k-mer values hold at most 31 bases"
        return ((revcomp_kmers(vals & _MASK32, 16) << (2 * (k - 16)))
                | revcomp_kmers(vals >> 32, k - 16))
    x = vals.to(torch.int64) & _MASK32
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = ((x >> 16) | (x << 16)) & _MASK32
    x = x ^ 0xAAAAAAAA
    return (x >> (2 * (16 - k))).to(vals.dtype)


def revcomp_kmers_np(vals: np.ndarray, k: int) -> np.ndarray:
    """NumPy twin of :func:`revcomp_kmers` (host-side LUT construction)."""
    assert k <= 16
    x = np.asarray(vals, dtype=np.uint32)
    x = ((x >> 2) & np.uint32(0x33333333)) | ((x & np.uint32(0x33333333)) << 2)
    x = ((x >> 4) & np.uint32(0x0F0F0F0F)) | ((x & np.uint32(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & np.uint32(0x00FF00FF)) | ((x & np.uint32(0x00FF00FF)) << 8)
    x = (x >> 16) | (x << 16)
    x = x ^ np.uint32(0xAAAAAAAA)
    return (x >> np.uint32(2 * (16 - k))).astype(np.asarray(vals).dtype)


def canonical_kmers(vals: torch.Tensor, k: int) -> torch.Tensor:
    """min(value, revcomp(value)) — count_kmer.cpp:86."""
    return torch.minimum(vals, revcomp_kmers(vals, k))


def kmer_window_values(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                       win_skip: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All k-mer window values of a read batch, with validity mask.

    Args:
      codes: (R, L) uint8 base codes; 4 marks N / pad.
      lengths: (R,) int32 read lengths.
      k: k-mer length, 1..31 (int32 values up to 15, int64 beyond).
      win_skip: optional (R,) int32 — windows starting before this offset
        are invalid (continuation rows of split reads repeat bases the
        previous row already counted).

    Returns:
      vals:  (R, L-k+1) forward k-mer values, int32 for k <= 15 and int64
        for k > 15 (garbage where invalid).
      valid: (R, L-k+1) bool — window is fully in-read and all-ACGT, which
        reproduces the reference's rolling reset on non-ACGT characters
        (count_kmer.cpp:73-78).
    """
    R, L = codes.shape
    W = L - k + 1
    assert W >= 1, f"max_read_len {L} < k {k}"
    assert 1 <= k <= 31, f"k={k} unsupported: k-mer values hold 1..31 bases"
    c = codes.to(torch.int32)
    safe = torch.where(c < 4, c, torch.zeros_like(c))
    acc = _assemble_windows(safe.to(kmer_value_dtype(k)), k, W)
    valid = _window_validity(c, lengths, k, W, win_skip)
    return acc, valid


def kmer_value_dtype(k: int) -> torch.dtype:
    """int32 for k <= 15; the 2k bits of k = 16..31 need int64."""
    return torch.int32 if k <= 15 else torch.int64


def _assemble_windows(safe: torch.Tensor, k: int, W: int) -> torch.Tensor:
    """Packed k-base window values in ``safe``'s dtype (int32, or int64
    for k > 15: no intermediate exceeds 2k bits), by binary doubling: span-2^m
    packed values (a_m[i] packs bases i..i+2^m-1), then k's binary
    decomposition ORed together — ceil(log2 k) + popcount(k) shifted
    ORs instead of k."""
    spans = {1: safe}
    m = 1
    while m * 2 <= k:
        prev = spans[m]
        spans[m * 2] = (prev[:, :prev.shape[1] - m] << (2 * m)) | prev[:, m:]
        m *= 2
    acc = torch.zeros((safe.shape[0], W), dtype=safe.dtype,
                      device=safe.device)
    off, rem = 0, k
    while rem:
        span = 1 << (rem.bit_length() - 1)
        acc |= spans[span][:, off:off + W] << (2 * (rem - span))
        off += span
        rem -= span
    return acc


def _window_validity(c: torch.Tensor, lengths: torch.Tensor, k: int, W: int,
                     win_skip: Optional[torch.Tensor]) -> torch.Tensor:
    invalid = (c >= 4).to(torch.int32)
    csum = torch.cumsum(invalid, dim=1, dtype=torch.int32)
    # bad(i) = number of invalid codes in [i, i+k)
    upper = csum[:, k - 1:k - 1 + W]
    lower = torch.nn.functional.pad(csum, (1, 0))[:, :W]
    bad = upper - lower
    starts = torch.arange(W, dtype=torch.int32, device=c.device)[None, :]
    valid = (bad == 0) & (starts + k <= lengths[:, None].to(torch.int32))
    if win_skip is not None:
        valid &= starts >= win_skip[:, None].to(torch.int32)
    return valid


def kmer_positions_np(seq, k: int):
    """Host-side (values, positions) of every N-free k-mer window of one
    ASCII sequence, 2-bit packed into uint64 (k <= 31); the assembly
    layer's anchor aligner indexes with it (asm/circular_logic.py)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    codes = encode_bases(seq)
    n = len(codes)
    if n < k:
        return (np.empty(0, np.uint64), np.empty(0, np.int64))
    W = n - k + 1
    acc = np.zeros(W, np.uint64)
    nbad = np.cumsum(codes >= 4)
    for j in range(k):
        acc = (acc << np.uint64(2)) | codes[j:j + W].astype(np.uint64)
    ok = (nbad[k - 1:] - np.concatenate([[0], nbad[:W - 1]])) == 0
    pos = np.flatnonzero(ok)
    return acc[pos], pos


_DECODE = np.frombuffer(b"ACTG", dtype=np.uint8)  # code 0,1,2,3


def decode_kmers(vals: np.ndarray, k: int) -> np.ndarray:
    """k-mer values -> ASCII strings (inverse of the 2-bit encode)."""
    vals = np.asarray(vals, dtype=np.uint64)
    chars = np.empty((len(vals), k), np.uint8)
    for j in range(k):
        chars[:, j] = _DECODE[(vals >> np.uint64(2 * (k - 1 - j)))
                              & np.uint64(3)]
    return chars.view(f"S{k}").ravel()


@functools.lru_cache(maxsize=None)
def _canonical_order(k: int) -> np.ndarray:
    """Sorted unique canonical k-mer values for small k (host-side)."""
    all_vals = np.arange(4 ** k, dtype=np.uint32)
    canon = np.minimum(all_vals, revcomp_kmers_np(all_vals, k))
    return np.unique(canon)


def canonical_order(k: int) -> np.ndarray:
    """Sorted unique canonical k-mer values — the TNF column key order
    (count_tnf.cpp:54-76). Column j of the TNF feature counts value
    canonical_order(k)[j]."""
    return _canonical_order(k)


def num_canonical_kmers(k: int) -> int:
    """136 for k=4, 32 for k=3 — the TNF feature widths
    (count_tnf.cpp:54-76 enumerates them into an ordered std::map)."""
    return int(_canonical_order(k).size)


@functools.lru_cache(maxsize=None)
def canonical_rank_lut(k: int) -> np.ndarray:
    """(4^k,) int32 LUT: k-mer value -> rank of its canonical form, in
    the std::map iteration order of count_tnf.cpp:108 (ascending
    canonical encoded value)."""
    order = _canonical_order(k)
    all_vals = np.arange(4 ** k, dtype=np.uint32)
    canon = np.minimum(all_vals, revcomp_kmers_np(all_vals, k))
    rank_of = np.zeros(4 ** k, dtype=np.int32)
    rank_of[order] = np.arange(order.size, dtype=np.int32)
    return rank_of[canon].astype(np.int32)
