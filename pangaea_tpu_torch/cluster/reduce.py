"""Random-projection point reduction ("skeleton" construction).

Port of pangaea_tpu/cluster/reduce.py. Behavior contract (reference
third_parties/rph_kmeans/rph_kmeans/point_reducer_base.py +
point_reducer_py.py):

- w: half the median distance of 1000 random point pairs
  (point_reducer_base.py:43-53) unless user-set.
- per iteration (point_reducer_py.py:47-88): draw proj_num=5 vectors
  ~ N(0, 1/w) and offsets b ~ U(0,1); bucket key = int32(X @ P + b)
  (truncation toward zero); points sharing all 5 keys merge into their
  weighted mean, accumulating weight; repeat until the group count is
  <= max_point (2000) or max_iter.
- the bucket-improvement modes (point_reducer_py.py:105-149: ``radius``,
  ``min_bkt_size``, ``min_center_dist``), which Pangaea never enables
  (src/clustering.py:17), need per-bucket member lists: when one is
  requested the reduction runs pangaea_tpu's host numpy path, with the
  same draws, and only the final nearest-skeleton labels are computed on
  the reducer's device.

Buckets are identified as in the JAX package, by two 32-bit hashes of the
five keys, and ordered by the unsigned (h1, h2) pair with ties by row id;
that order sets the order of the reduced points, which feeds sklearn's
k-means++ seeding, so it is reproduced exactly. The uint32 hash
arithmetic runs in int64, masked to 32 bits after every step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pangaea_tpu_torch.utils import DeviceLike, resolve_device

_M32 = 0xFFFFFFFF


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for v in [0, 2^32), without int64 overflow: the
    constant is split in 16-bit halves so every product stays < 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (v * lo + (((v * hi) & 0xFFFF) << 16)) & _M32


def _mix(v: torch.Tensor, seed: int) -> torch.Tensor:
    v = _mul32(v, 0x9E3779B9) ^ seed
    v = _mul32(v ^ (v >> 16), 0x85EBCA6B)
    v = _mul32(v ^ (v >> 13), 0xC2B2AE35)
    return v ^ (v >> 16)


def _reduce_step(x: torch.Tensor, weight: torch.Tensor, active: torch.Tensor,
                 proj: torch.Tensor, b: torch.Tensor, *, n: int):
    """One bucketing+merge pass over padded arrays.

    Args:
      x: (G, D) f32 current points (garbage on inactive rows).
      weight: (G,) f32 merge weights.
      active: (G,) bool validity.
      proj: (D, P) f32 projection vectors; b: (P,) offsets.

    Returns (new_x, new_weight, new_active, count): merged groups occupy
    the first ``count`` slots in bucket-key sort order.
    """
    G = x.shape[0]
    dev = x.device
    keys = (x @ proj + b).to(torch.int32)  # trunc toward zero
    h1 = torch.zeros(G, dtype=torch.int64, device=dev)
    h2 = torch.zeros(G, dtype=torch.int64, device=dev)
    for c in range(keys.shape[1]):
        kc = keys[:, c].to(torch.int64) & _M32  # uint32 view of int32
        h1 = _mul32(h1, 16777619) ^ _mix(kc, 0x2545F491 + c)
        h2 = _mul32(h2, 0x01000193) ^ _mix(kc, 0x7FEB352D ^ (c << 8))
    # inactive rows: per-row sentinel hashes so they never merge with
    # each other (a match with an active bucket is harmless: weight 0)
    row_ids = torch.arange(G, dtype=torch.int64, device=dev)
    h1 = torch.where(active, h1, row_ids)
    h2 = torch.where(active, h2, _M32 ^ row_ids)
    # unsigned (h1, h2) order as one exact signed int64 key
    key = (h1 - (1 << 31)) * (1 << 32) + h2
    skey, sidx = torch.sort(key, stable=True)
    newflag = torch.ones(G, dtype=torch.bool, device=dev)
    newflag[1:] = skey[1:] != skey[:-1]
    seg_sorted = torch.cumsum(newflag.to(torch.int64), 0) - 1
    inv = torch.empty(G, dtype=torch.int64, device=dev)
    inv[sidx] = seg_sorted
    w_active = torch.where(active, weight, torch.zeros_like(weight))
    bucket_w = torch.zeros(n, dtype=x.dtype, device=dev).index_add_(
        0, inv, w_active)
    bucket_x = torch.zeros((n, x.shape[1]), dtype=x.dtype,
                           device=dev).index_add_(0, inv, x * w_active[:, None])
    new_active = bucket_w > 0
    denom = torch.where(new_active, bucket_w, torch.ones_like(bucket_w))
    new_x = bucket_x / denom[:, None]
    act = new_active.to(torch.int64)
    count = act.sum()
    # compact live buckets to the front, in bucket order
    dst = torch.where(new_active, torch.cumsum(act, 0) - 1,
                      count + torch.cumsum(1 - act, 0) - 1)
    out_x = torch.zeros_like(new_x)
    out_x[dst] = new_x
    out_w = torch.zeros_like(bucket_w)
    out_w[dst] = bucket_w
    out_active = torch.arange(n, device=dev) < count
    return out_x, out_w, out_active, count


def _pow2_pad(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class RPPointReducer:
    """fit_transform(X) -> (reduced_X, weights, labels, n_iter).

    ``bkt_improve`` selects a bucket-improvement mode (``radius`` with
    ``radius_divide``, ``min_bkt_size`` with ``bkt_size_keepr`` < 1,
    ``min_center_dist`` with ``center_dist_keepr`` < 1); any mode runs
    the host numpy path."""

    def __init__(self, w: Optional[float] = None, max_point: int = 2000,
                 proj_num: int = 5, max_iter: int = 1000,
                 sample_dist_num: int = 1000,
                 bkt_improve: Optional[str] = None,
                 radius_divide: Optional[float] = None,
                 bkt_size_keepr: float = 1.0,
                 center_dist_keepr: float = 1.0,
                 rng: Optional[np.random.RandomState] = None,
                 device: DeviceLike = None):
        self.w = w
        self.max_point = max_point
        self.proj_num = proj_num
        self.max_iter = max_iter
        self.sample_dist_num = sample_dist_num
        self.bkt_improve = bkt_improve
        self.radius2 = radius_divide ** 2 if radius_divide else None
        self.bkt_size_keepr = bkt_size_keepr
        self.center_dist_keepr = center_dist_keepr
        self.rng = rng or np.random.RandomState()
        self.device = resolve_device(device)

    def get_w(self, X: np.ndarray) -> float:
        """Half median pairwise distance of sampled pairs
        (point_reducer_base.py:43-53)."""
        if self.w is not None:
            return float(self.w)
        n = X.shape[0]
        i = self.rng.choice(n, self.sample_dist_num)
        j = self.rng.choice(n, self.sample_dist_num)
        d = np.linalg.norm(X[i] - X[j], axis=1)
        return float(np.median(d) * 0.5)

    def fit_transform(self, X: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        X = np.ascontiguousarray(X, dtype=np.float32)
        n, dim = X.shape
        w = self.get_w(X)
        if self.max_point >= n:
            return (X, np.ones(n, X.dtype), np.arange(n, dtype=np.uint32), 0)
        if self.bkt_improve is not None:
            return self._fit_transform_numpy(X, w)
        dev = self.device
        size = _pow2_pad(n)
        x = torch.zeros((size, dim), dtype=torch.float32, device=dev)
        x[:n] = torch.from_numpy(X).to(dev)
        weight = torch.zeros(size, dtype=torch.float32, device=dev)
        weight[:n] = 1.0
        active = torch.arange(size, device=dev) < n
        count = n
        it = 0
        while it < self.max_iter and count > self.max_point:
            proj = torch.from_numpy(self.rng.normal(
                0.0, 1.0 / w, size=(dim, self.proj_num)).astype(np.float32)
            ).to(dev)
            b = torch.from_numpy(self.rng.uniform(
                0, 1, size=(self.proj_num,)).astype(np.float32)).to(dev)
            x, weight, active, cnt = _reduce_step(x, weight, active, proj,
                                                  b, n=size)
            count = int(cnt)
            it += 1
            # shrink padding once the live region is much smaller
            new_size = _pow2_pad(count)
            if new_size < size:
                x, weight, active = (x[:new_size], weight[:new_size],
                                     active[:new_size])
                size = new_size
        reduced_x = x[:count].cpu().numpy()
        weights = weight[:count].cpu().numpy()
        # final labels: nearest reduced point (downstream only uses the
        # skeleton and weights on Pangaea's path)
        return reduced_x, weights, self._labels(X, reduced_x), it

    def _labels(self, X: np.ndarray, reduced: np.ndarray) -> np.ndarray:
        dev = self.device
        return _nearest_labels(torch.from_numpy(X).to(dev),
                               torch.from_numpy(reduced).to(dev)
                               ).cpu().numpy().astype(np.uint32)

    # ---- numpy path (bucket-improvement modes) --------------------------

    def _fit_transform_numpy(self, X: np.ndarray, w: float):
        """Dict-bucketing reduction with bucket improvement
        (point_reducer_py.py:47-149 contract)."""
        n, dim = X.shape
        reduced = X
        weight = np.ones(n, np.float64)
        it = 0
        while it < self.max_iter and len(reduced) > self.max_point:
            proj = self.rng.normal(0.0, 1.0 / w,
                                   (dim, self.proj_num)).astype(np.float32)
            b = self.rng.uniform(0, 1, self.proj_num).astype(np.float32)
            keys = (reduced @ proj + b).astype(np.int32)
            buckets = {}
            for i in range(len(reduced)):
                buckets.setdefault(keys[i].tobytes(), []).append(i)
            groups = [v for v in buckets.values() if len(v) > 1]
            orphans = [v[0] for v in buckets.values() if len(v) == 1]
            if self.bkt_improve == "radius" and self.radius2 is not None:
                groups, orphans = self._radius_improve(groups, orphans,
                                                       reduced)
            elif (self.bkt_improve == "min_bkt_size"
                  and self.bkt_size_keepr < 1.0):
                groups, orphans = self._keepr_improve(
                    groups, orphans, [len(g) for g in groups],
                    self.bkt_size_keepr)
            elif (self.bkt_improve == "min_center_dist"
                  and self.center_dist_keepr < 1.0):
                meds = []
                for g in groups:
                    c = reduced[g].mean(axis=0)
                    meds.append(float(np.median(
                        np.square(reduced[g] - c).sum(axis=1))))
                groups, orphans = self._keepr_improve(
                    groups, orphans, meds, self.center_dist_keepr)
            new_x, new_w = [], []
            for g in groups:
                wt = weight[g]
                tot = wt.sum()
                new_x.append((reduced[g] * wt[:, None]).sum(axis=0) / tot)
                new_w.append(tot)
            for o in orphans:
                new_x.append(reduced[o])
                new_w.append(weight[o])
            reduced = np.asarray(new_x, dtype=np.float32)
            weight = np.asarray(new_w, dtype=np.float64)
            it += 1
        return (reduced, weight.astype(np.float32), self._labels(X, reduced),
                it)

    @staticmethod
    def _keepr_improve(groups, orphans, scores, keepr):
        """min_bkt_size / min_center_dist: keep the keepr fraction with the
        smallest score, orphan the rest (point_reducer_py.py:131-149)."""
        order = np.argsort(scores)
        keep_num = int(len(groups) * keepr)
        kept = [groups[i] for i in order[:keep_num]]
        for i in order[keep_num:]:
            orphans.extend(groups[i])
        return kept, orphans

    def _radius_improve(self, groups, orphans, X):
        """Greedy radius sub-clustering per bucket
        (point_reducer_py.py:105-129)."""
        new_groups = []
        for bkt in groups:
            pts = X[bkt]
            centers = [0]
            sub = [[0]]
            for i in range(1, len(bkt)):
                d2 = np.square(pts[centers] - pts[i]).sum(axis=1)
                c = int(np.argmin(d2))
                if d2[c] < self.radius2:
                    sub[c].append(i)
                else:
                    centers.append(i)
                    sub.append([i])
            for g in sub:
                if len(g) == 1:
                    orphans.append(bkt[g[0]])
                else:
                    new_groups.append([bkt[r] for r in g])
        return new_groups, orphans


def _nearest_labels(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    d = ((X * X).sum(1, keepdim=True) - 2.0 * X @ C.T
         + (C * C).sum(1)[None, :])
    return torch.argmin(d, dim=1).to(torch.int32)
