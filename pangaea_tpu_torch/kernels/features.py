"""Barcode-feature kernels: k-mer keys, abundance bins, per-group
histograms, and the dense global count table.

Port of pangaea_tpu/kernels/features.py. The contract is the reference's
per-barcode feature join (count_kmer.cpp:55-108, count_tnf.cpp:78-113):

1. every window of the read stream gets its canonical k-mer as a sort key
   (the sentinel 4^k for invalid windows) — :func:`batch_kmer_keys`. Keys
   are int32 for k <= 15 and int64 for k = 16..31: the 2k-bit value
   ``(hi << 32) | lo`` of pangaea_tpu's split-word pair, whose sentinel
   pair ``(4^(k-16), 0)`` packs to the same 4^k, and whose two-key
   ``lax.sort(num_keys=2)`` order is the int64 order. Every join below
   takes either key dtype; positions, weights and the CUDA scans stay
   int32;
2. one sort by key groups equal k-mers into runs; the run length IS the
   jellyfish global count (the stream holds every read once, dropped
   groups as seg -1 rows, unmasked); bin = count // window, kept when
   < vector_size — :func:`sortjoin_bins`. The run boundaries are filled
   with the CUDA prefix scans (kernels/scan.py);
3. bins are histogrammed per barcode group — :func:`abundance_histogram_from_bins`
   — and the canonical 4-mers likewise — :func:`tnf_histogram_segsum`.

Two variants of step 2 serve the rest of step 1:

- the quality-masked (weighted) join of paired input —
  :func:`batch_kmer_keys_weighted`, :func:`sortjoin_bins_weighted`: the
  global count is a run's int64 weight sum, added up by run id (the run
  ids come from the CUDA cumsum of the run starts);
- the past-the-cap spill — :func:`spill_aggregate`,
  :func:`spill_aggregate_weighted`, :func:`map_run_bins`: each in-cap
  chunk of windows is sorted and run-length encoded on the device, only
  its unique (key, weight sum) runs are joined, and a per-run bin table
  maps every window back to its bin.

The dense-table paths (``hist_impl='scatter'|'segsum'``, k <= 15) count
every window into a (4^k,) int32 table first (:func:`count_kmers_global`,
jellyfish's global pass) and look each window's count up in the group
pass (:func:`abundance_histogram`). pangaea_tpu's 'segsum' is a TPU
formulation of the same outputs (a compare-expand, 128-lane row gathers
of the table and a cumsum segment sum); the port runs these table
functions for both names.

Where the TPU formulation worked around the TPU, the port takes the
direct route with equal outputs: the restore of bins (or run ids) to
stream order is a permutation scatter instead of a packed second sort,
the unique runs are gathered at the run starts instead of compacted by a
third sort, a run-bin lookup is a plain gather instead of a 128-lane row
gather, and the per-group histograms are one scatter-add over
``seg * columns + column`` (integer adds are exact in any order) instead
of a compare-expand plus a cumsum/searchsorted segment sum.
"""

from __future__ import annotations

import torch

from pangaea_tpu_torch.kernels import scan
from pangaea_tpu_torch.kernels.encode import (_window_validity,
                                              canonical_kmers,
                                              canonical_rank_lut,
                                              kmer_window_values)


def kmer_key_sentinel(k: int) -> int:
    """Sort key for invalid windows: sorts after every real k-mer value."""
    return 4 ** k


# ---- dense-table paths (k <= 15) -----------------------------------------


def make_global_table(k: int, device) -> torch.Tensor:
    """Dense canonical-k-mer count table on ``device``: entry i holds the
    global count of k-mer value i (0 = absent, as in a jellyfish dump of
    counts >= 1). 4^15 int32 is 4 GiB."""
    if k > 15:
        raise ValueError(f"k={k}: the dense 4^k table exists for k <= 15 "
                         "only; larger k runs the sort-join")
    return torch.zeros(4 ** k, dtype=torch.int32, device=device)


def count_kmers_global(table: torch.Tensor, codes: torch.Tensor,
                       lengths: torch.Tensor, cont: torch.Tensor, *, k: int,
                       overlap: int) -> torch.Tensor:
    """Add one read batch's canonical k-mer counts to ``table``, in place.
    pangaea_tpu drops invalid windows with an out-of-range scatter index
    (``mode="drop"``), which torch checks as a device assert; the port
    masks them out first and scatter-adds the rest (``index_add_`` on the
    int32 table: integer adds commute, so the counts are exact)."""
    skip = cont.to(torch.int32) * max(0, overlap - (k - 1))
    vals, valid = kmer_window_values(codes, lengths, k, win_skip=skip)
    idx = canonical_kmers(vals, k)[valid]
    table.index_add_(0, idx, torch.ones_like(idx))
    return table


def abundance_histogram(hist: torch.Tensor, table: torch.Tensor,
                        codes: torch.Tensor, lengths: torch.Tensor,
                        seg_ids: torch.Tensor, cont: torch.Tensor, *, k: int,
                        window: int, vector_size: int,
                        overlap: int) -> torch.Tensor:
    """Add one batch's per-group abundance counts to the (n_groups,
    vector_size) int32 histogram, in place (count_kmer.cpp:86-96): each
    valid window's global count is looked up in ``table``; bin = count //
    window, kept if the count is > 0 and the bin < vector_size."""
    skip = cont.to(torch.int32) * max(0, overlap - (k - 1))
    vals, valid = kmer_window_values(codes, lengths, k, win_skip=skip)
    canon = torch.where(valid, canonical_kmers(vals, k), 0)
    cnt = torch.index_select(table, 0, canon.reshape(-1)).view_as(canon)
    bins = torch.div(cnt, window, rounding_mode="floor")
    binv = torch.where(valid & (cnt > 0) & (bins < vector_size), bins, -1)
    return abundance_histogram_from_bins(hist, binv, seg_ids,
                                         vector_size=vector_size)


_SORTJOIN_PAD_QUANTUM = 1 << 20  # 1M


def sortjoin_pad_size(n: int) -> int:
    """Padded sort length: the next power of two up to 1M, else the next
    1M multiple (pangaea_tpu's padding; kept so the sorted length, and
    with it the scan shapes, match the reference package)."""
    if n <= _SORTJOIN_PAD_QUANTUM:
        return 1 << max(0, (n - 1)).bit_length()
    q = _SORTJOIN_PAD_QUANTUM
    return ((n + q - 1) // q) * q


def batch_kmer_keys(codes: torch.Tensor, lengths: torch.Tensor,
                    cont: torch.Tensor, *, k: int, overlap: int
                    ) -> torch.Tensor:
    """(R*W,) canonical k-mer per window (int32, or int64 for k > 15:
    ``encode.kmer_value_dtype``); invalid -> 4^k sentinel (2^62 at k = 31).

    ``cont`` (R,) marks continuation rows of split reads: their first
    max(0, overlap-(k-1)) windows were counted by the previous row."""
    skip = cont.to(torch.int32) * max(0, overlap - (k - 1))
    vals, valid = kmer_window_values(codes, lengths, k, win_skip=skip)
    canon = canonical_kmers(vals, k)
    return torch.where(valid, canon, kmer_key_sentinel(k)).reshape(-1)


def sortjoin_bins(keys: torch.Tensor, *, k: int, window: int,
                  vector_size: int) -> torch.Tensor:
    """Per-window abundance bin (count // window) in original order; -1
    for windows that contribute nothing (invalid, or bin >= vector_size).

    keys: (N,) from :func:`batch_kmer_keys` (int32, or int64 for k > 15),
    padding entries equal to the sentinel. One stable sort groups equal
    keys; each instance's global count is the length of its run, from
    the run start and end positions filled forward (cummax) and backward
    (cummin_reverse) — the two CUDA scans of the main path. A
    permutation scatter puts each bin back at its window's position,
    which satisfies the row-grouped contract of pangaea_tpu's
    ``sortjoin_bins_rowgrouped`` (each row's multiset of bins) and the
    exact order of its ``sortjoin_bins``."""
    n = keys.numel()
    sk, si = torch.sort(keys, stable=True)
    start, end = _run_flags(sk)
    pos = torch.arange(n, dtype=torch.int32, device=keys.device)
    run_start = scan.cummax(torch.where(start, pos, 0))
    run_end = scan.cummin_reverse(torch.where(end, pos, n))
    del start, end, pos
    count = run_end - run_start + 1
    del run_start, run_end
    bins = torch.div(count, window, rounding_mode="floor")
    ok = (sk < kmer_key_sentinel(k)) & (bins < vector_size)
    binv = torch.where(ok, bins, -1)
    del sk, bins, ok
    out = torch.empty_like(binv)
    out[si] = binv
    return out


def _run_flags(sk: torch.Tensor):
    """(start, end) bool flags of the runs of equal sorted keys."""
    start = torch.ones(sk.numel(), dtype=torch.bool, device=sk.device)
    start[1:] = sk[1:] != sk[:-1]
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    return start, end


def _run_ids(start: torch.Tensor) -> torch.Tensor:
    """(N,) int32 run id of every sorted element: the CUDA cumsum of the
    run-start flags, minus one."""
    return scan.cumsum(start.to(torch.int32)) - 1


def _run_weight_sums(sw: torch.Tensor, run_id: torch.Tensor) -> torch.Tensor:
    """(n_runs,) int64 weight sum of every run: one int64 ``index_add_``
    of the sorted weights by run id. pangaea_tpu fills the run totals from
    an int32 weight cumsum, which wraps once the weights joined in one
    call sum past 2^31 - 1 and then gives every run before the wrap a
    count <= 0; int64 sums cannot wrap."""
    n_runs = int(run_id[-1]) + 1 if run_id.numel() else 0
    sums = torch.zeros(n_runs, dtype=torch.int64, device=sw.device)
    return sums.index_add_(0, run_id, sw.to(torch.int64))


# ---- quality-masked (weighted) sort-join ----------------------------------
#
# The paired-reads path quality-masks the GLOBAL count only: jellyfish
# runs with --min-qual-char=? (src/feature.py:76-86, bases below '?'
# become N before counting) while count_kmer's group scan reads raw
# bases and just looks counts up (count_kmer.cpp:87). Masking never maps
# one valid k-mer to another — a masked base makes the window invalid —
# so the masked global count of key K is exactly the number of K's
# instances whose window contains no masked base. One weighted sort
# therefore serves both sides: every window routes its UNMASKED key,
# carrying weight 1 iff the window survives masking; the run weight sum
# is the jellyfish masked count, and `count > 0` reproduces the "absent
# from the dump" skip.


def batch_kmer_keys_weighted(codes: torch.Tensor, lowq: torch.Tensor,
                             lengths: torch.Tensor, cont: torch.Tensor, *,
                             k: int, overlap: int):
    """(keys, weights) per window, both (R*W,): keys as
    :func:`batch_kmer_keys` (unmasked), int32 weight 1 iff the window is
    valid AFTER quality masking (no invalid and no low-quality base among
    its k bases — jellyfish --min-qual-char semantics). ``lowq``: (R, L)
    nonzero where quality < min_qual_char."""
    skip = cont.to(torch.int32) * max(0, overlap - (k - 1))
    vals, valid = kmer_window_values(codes, lengths, k, win_skip=skip)
    keys = torch.where(valid, canonical_kmers(vals, k), kmer_key_sentinel(k))
    c = codes.to(torch.int32)
    masked = torch.where(lowq != 0, torch.full_like(c, 4), c)
    wvalid = _window_validity(masked, lengths, k, keys.shape[1], skip)
    return keys.reshape(-1), wvalid.to(torch.int32).reshape(-1)


def sortjoin_bins_weighted(keys: torch.Tensor, weights: torch.Tensor, *,
                           k: int, window: int, vector_size: int
                           ) -> torch.Tensor:
    """Masked-global sort-join: per-window abundance bin in original
    order where the global count is the window's run WEIGHT SUM; -1 for
    invalid windows, keys absent from the masked global multiset (count
    0), or bin >= vector_size. keys: (N,) int32 or int64, weights: (N,)
    int32, padding entries the sentinel with weight 0. Runs one CUDA
    scan, the cumsum of the run starts that gives the run ids; the run
    weight sums are int64 (:func:`_run_weight_sums`), so the bins stay
    exact past a total weight of 2^31 - 1. The output is int32."""
    sk, si = torch.sort(keys, stable=True)
    start, _ = _run_flags(sk)
    run_id = _run_ids(start)
    del start
    count = _run_weight_sums(weights[si], run_id)[run_id]
    del run_id
    bins = torch.div(count, window, rounding_mode="floor")
    ok = (sk < kmer_key_sentinel(k)) & (count > 0) & (bins < vector_size)
    binv = torch.where(ok, bins, -1).to(torch.int32)
    del sk, count, bins, ok
    out = torch.empty_like(binv)
    out[si] = binv
    return out


# ---- spill pre-aggregation (past-the-cap streaming) -----------------------
#
# Past the device window cap, phase-A windows cannot all stay on the
# device. Genomic k-mer multiplicities are Zipfian, so each in-cap chunk
# of windows is aggregated ON THE DEVICE first:
#
#   1. sort the chunk's windows by key;
#   2. run-length encode: run starts, per-run weight sum (the run length
#      on the unmasked path; the quality-masked paired path sums its 0/1
#      window weights);
#   3. scatter each window's RUN ID back to stream order — the only
#      per-window artifact, an int32 that can stay on the device, or go
#      to host RAM or disk;
#   4. gather the unique (key, weight sum) runs at the run starts, in
#      sorted-key order (valid runs first, the sentinel run last).
#
# Phase B joins the unique entries of all chunks through the weighted
# sort-join (exact: equal keys' weight sums add), and phase C maps run
# ids to bins with one gather per chunk (:func:`map_run_bins`).


def _spill_aggregate(keys: torch.Tensor, weights, k: int):
    n = keys.numel()
    sk, si = torch.sort(keys, stable=True)
    start, end = _run_flags(sk)
    run_id = _run_ids(start)
    starts = torch.nonzero(start).squeeze(1)
    if weights is None:
        pos = torch.arange(n, dtype=torch.int32, device=keys.device)
        run_start = scan.cummax(torch.where(start, pos, 0))
        run_end = scan.cummin_reverse(torch.where(end, pos, n))
        uniq_w = (run_end - run_start + 1)[starts]
        del pos, run_start, run_end
    else:
        # int32 like the stores' rows: one chunk's run sum is at most its
        # window count (spill_agg_windows, 2^25 by default), far below
        # 2^31; phase B sums the chunks' runs in int64
        uniq_w = _run_weight_sums(weights[si], run_id).to(torch.int32)
    run_ids_stream = torch.empty_like(run_id)
    run_ids_stream[si] = run_id
    del run_id, si
    uniq = sk[starts]
    n_runs = starts.numel()
    n_valid = int((uniq < kmer_key_sentinel(k)).sum())
    return run_ids_stream, uniq, uniq_w, n_runs, n_valid


def spill_aggregate(keys: torch.Tensor, *, k: int):
    """Unmasked chunk aggregation (see the note above): (run_ids_stream,
    unique_keys, unique_weight_sums, n_runs, n_valid). Keys of either
    dtype: int64 keys (k > 15) stand for pangaea_tpu's split-word
    ``spill_aggregate_pair``.

    ``run_ids_stream`` (N,) int32 is each window's run id in stream
    order; the unique arrays (keys in the keys' dtype) hold the n_runs
    runs in sorted-key order, the first n_valid of them real k-mers, the
    rest the sentinel run of invalid windows (at most one). n_runs and
    n_valid are host ints."""
    return _spill_aggregate(keys, None, k)


def spill_aggregate_weighted(keys: torch.Tensor, weights: torch.Tensor, *,
                             k: int):
    """Quality-masked chunk aggregation: as :func:`spill_aggregate`,
    with run weight sums of the 0/1 window weights (for int64 keys,
    pangaea_tpu's ``spill_aggregate_pair_weighted``)."""
    return _spill_aggregate(keys, weights, k)


def map_run_bins(table: torch.Tensor, run_ids: torch.Tensor) -> torch.Tensor:
    """Per-window bins from a per-run bin table (phase C of the
    aggregated spill): ``table[run_ids]``. The table holds -1 for the
    sentinel run and for runs whose k-mer gets no bin, so pad and invalid
    windows come back -1 exactly like :func:`sortjoin_bins`."""
    return torch.index_select(table, 0, run_ids)


def abundance_histogram_from_bins(hist: torch.Tensor, bins: torch.Tensor,
                                  seg_ids: torch.Tensor, *,
                                  vector_size: int) -> torch.Tensor:
    """Add one batch's per-window bins to the (n_groups, vector_size)
    int32 histogram, in place. bins: (R, W) int32, -1 = skip; seg_ids:
    (R,) group per row, -1 = dropped group / padding."""
    keep = (bins >= 0) & (seg_ids[:, None] >= 0)
    flat = seg_ids[:, None].to(torch.int64) * vector_size + bins
    _add_counts(hist, flat[keep])
    return hist


def tnf_histogram_segsum(hist: torch.Tensor, codes: torch.Tensor,
                         lengths: torch.Tensor, seg_ids: torch.Tensor,
                         cont: torch.Tensor, *, k: int, overlap: int,
                         rank_lut: torch.Tensor) -> torch.Tensor:
    """Add one batch's canonical k-mer (TNF) counts to the
    (n_groups, num_cols) int32 histogram, in place: the port of both
    pangaea_tpu's ``tnf_histogram`` (the table paths) and its
    ``tnf_histogram_segsum`` (the sort-join). Column j counts the
    j-th smallest canonical k-mer (count_tnf.cpp:108 order), looked up
    through ``rank_lut`` = :func:`canonical_rank_lut` (k) on the device.
    Every valid window of a kept group counts (count_tnf.cpp:89-109)."""
    skip = cont.to(torch.int32) * max(0, overlap - (k - 1))
    vals, valid = kmer_window_values(codes, lengths, k, win_skip=skip)
    keep = valid & (seg_ids[:, None] >= 0)
    ranks = rank_lut[vals[keep].to(torch.int64)].to(torch.int64)
    rows = seg_ids[:, None].expand_as(vals)[keep].to(torch.int64)
    _add_counts(hist, rows * hist.shape[1] + ranks)
    return hist


def rank_lut_tensor(k: int, device) -> torch.Tensor:
    """:func:`canonical_rank_lut` as an int32 tensor on ``device``."""
    return torch.from_numpy(canonical_rank_lut(k)).to(device)


def _add_counts(hist: torch.Tensor, flat_idx: torch.Tensor) -> None:
    """hist.view(-1)[i] += 1 for every i in flat_idx (exact: integer
    adds commute)."""
    counts = torch.bincount(flat_idx, minlength=hist.numel())
    hist.view(-1).add_(counts.to(hist.dtype))
