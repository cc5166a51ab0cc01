"""BIC-based k selection over RPH skeletons.

Port of pangaea_tpu/cluster/k_selection.py. Behavior contract (reference
third_parties/rph_kmeans/rph_kmeans/k_selection.py):

- BIC of a weighted clustering (k_selection.py:36-84): spherical-gaussian
  log-likelihood with pooled variance ``inertia / ((n - k) * d)``, minus
  ``0.5 * k*(d+1) * log(n)``; higher is better.
- select_k_with_bic (k_selection.py:127-176): ske_repeat skeletons; per
  skeleton, mean BIC of k_repeat KMeans runs for each k in [kmin, kmax];
  knee of each skeleton's k-BIC curve via Kneedle (concave/increasing,
  sensitivity S falling back 3 -> 2 -> 1); optimal k = round(mean of
  per-skeleton knees).

:func:`kneedle` is pangaea_tpu's self-contained Kneedle detection for the
concave/increasing case (Satopaa et al. 2011), the only case the
reference exercises.

The skeleton reductions run on the caller's device. Each skeleton fit is
``cluster/skeleton.weighted_kmeans`` (the numpy reproduction of the
sklearn KMeans call pangaea_tpu makes), and the fits run in a ``spawn``
process pool, as the reference runs its skeletons in a multiprocessing
pool (k_selection.py:158-163). Every draw from the one ``RandomState``
happens first, in pangaea_tpu's order: per skeleton, the reducer's draws,
then one fit seed per (k, repeat) in k-major order. A fit consumes only
its own seed, so the pool returns pangaea_tpu's sequential results with
any worker count.

One fault of pangaea_tpu is not copied. A k with no fewer skeleton points
than clusters gets a BIC of -inf, and pangaea_tpu hands those entries to
Kneedle too: they make every normalised value NaN, so no knee is found
and the best-BIC fall-back picks the largest feasible k. On a latent of
well-separated clusters and more than ``max_point`` rows, one reduction
round already leaves a few dozen points, so that k is about the skeleton
size, and the final RPH-KMeans, whose own skeletons are as small, raises.
The port runs Kneedle on the feasible k of each curve only. Where every k
is feasible (a skeleton of more than ``kmax`` points) the two are the
same; the BIC lists, with their -inf entries, always are.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pangaea_tpu_torch.cluster.reduce import RPPointReducer
from pangaea_tpu_torch.cluster.skeleton import fit_skeletons
from pangaea_tpu_torch.utils import DeviceLike


def cal_inertia(X: np.ndarray, y: np.ndarray, centers: np.ndarray,
                weight: np.ndarray) -> float:
    inertia = 0.0
    for i in range(centers.shape[0]):
        idx = np.where(y == i)
        inertia += (np.square(X[idx] - centers[i]).sum(axis=1)
                    * weight[idx]).sum()
    return float(inertia)


def cal_log_likelihood(X: np.ndarray, y: np.ndarray, centers: np.ndarray,
                       weight: np.ndarray, eps: float = 1e-100) -> float:
    n, d = X.shape
    k = centers.shape[0]
    denom = max((n - k) * d, 1)  # guard skeletons collapsed to ~k points
    variance = max(eps, cal_inertia(X, y, centers, weight) / denom)
    total_weight = weight.sum()
    ll = 0.0
    for i in range(k):
        gsz = weight[y == i].sum()
        if gsz <= 0:
            continue
        ll += gsz * np.log(gsz)
        ll -= gsz * np.log(total_weight)
        ll -= 0.5 * gsz * d * np.log(2.0 * np.pi * variance)
        ll -= 0.5 * d * (gsz - 1)
    return float(ll)


def cal_bic(X: np.ndarray, y: np.ndarray, centers: np.ndarray,
            weight: Optional[np.ndarray] = None) -> float:
    if weight is None:
        weight = np.ones(X.shape[0], dtype=X.dtype)
    para_num = centers.shape[0] * (X.shape[1] + 1)
    return (cal_log_likelihood(X, y, centers, weight)
            - 0.5 * para_num * np.log(X.shape[0]))


def kneedle(x: Sequence[float], y: Sequence[float], S: float = 1.0
            ) -> Optional[float]:
    """Knee of a concave increasing curve; None if no knee found."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if len(x) < 3:
        return None
    xr = x.max() - x.min()
    yr = y.max() - y.min()
    if xr == 0 or yr == 0:
        return None
    xn = (x - x.min()) / xr
    yn = (y - y.min()) / yr
    yd = yn - xn
    lmx = [i for i in range(1, len(yd) - 1)
           if yd[i] >= yd[i - 1] and yd[i] > yd[i + 1]]
    if not lmx:
        return None
    thresh_drop = S * np.mean(np.diff(xn))
    for li, i in enumerate(lmx):
        t = yd[i] - thresh_drop
        nxt = lmx[li + 1] if li + 1 < len(lmx) else len(yd)
        for j in range(i + 1, nxt):
            if yd[j] < t:
                return float(x[i])
    return None


def _skeleton_jobs(X: np.ndarray, s: int, k_range: Sequence[int],
                   k_repeat: int, reducer_kwargs: dict,
                   rng: np.random.RandomState, device: DeviceLike):
    """Reduce X to skeleton ``s`` and draw its fit seeds: the draws of
    pangaea_tpu's ``skeleton_bic_curve``, in its order, without the fits.
    Returns ((points, weights), jobs); no job for an infeasible k."""
    reducer = RPPointReducer(rng=rng, device=device, **reducer_kwargs)
    skel, weight, _, _ = reducer.fit_transform(X)
    jobs = [(s, k, rng.randint(2**31 - 1))
            for k in k_range if k < len(skel)  # else fewer points than k
            for _ in range(k_repeat)]
    return (skel, weight), jobs


def _bic_lists(skeletons, jobs, k_range: Sequence[int],
               workers: int) -> List[List[float]]:
    """Run the jobs' fits; per skeleton, the mean BIC of each k's fits,
    -inf where k is infeasible."""
    vals = {}
    for (s, k, _), (centers, y) in zip(
            jobs, fit_skeletons(skeletons, jobs, workers)):
        skel, weight = skeletons[s]
        # float32 centers, as sklearn's cluster_centers_ for float32 input
        vals.setdefault((s, k), []).append(
            cal_bic(skel, y, centers.astype(np.float32), weight))
    return [[float(np.mean(vals[s, k])) if (s, k) in vals else -np.inf
             for k in k_range] for s in range(len(skeletons))]


def skeleton_bic_curve(X: np.ndarray, k_range: Sequence[int],
                       k_repeat: int, reducer_kwargs: dict,
                       rng: np.random.RandomState, device: DeviceLike = None,
                       workers: int = 1) -> List[float]:
    """One skeleton's mean BIC per k (-inf for k >= its point count)."""
    skel, jobs = _skeleton_jobs(X, 0, k_range, k_repeat, reducer_kwargs,
                                rng, device)
    return _bic_lists([skel], jobs, k_range, workers)[0]


def select_k_with_bic(X: np.ndarray, kmax: int, kmin: int = 2,
                      ske_repeat: int = 30, k_repeat: int = 5,
                      kneedle_s: float = 3.0,
                      point_reducer_kwargs: Optional[dict] = None,
                      random_state: Optional[int] = None,
                      device: DeviceLike = None, workers: int = 1,
                      stats: Optional[dict] = None
                      ) -> Tuple[int, List[List[float]], List[int]]:
    """Returns (optimal_k, bic_lists, k_range) — k_selection.py:127-176.

    The reductions run on ``device``; the fits run in ``workers``
    processes (1: inline). ``stats``, when given, receives the seconds of
    the reductions (``reduce_s``) and of the fits with their BIC
    (``fits_s``), the number of fits, the worker count and the
    (points, weights) skeletons."""
    rng = np.random.RandomState(random_state)
    k_range = list(range(kmin, kmax + 1))
    kwargs = point_reducer_kwargs or {}
    t0 = time.perf_counter()
    skeletons, jobs = [], []
    for s in range(ske_repeat):
        skel, skel_jobs = _skeleton_jobs(X, s, k_range, k_repeat, kwargs,
                                         rng, device)
        skeletons.append(skel)
        jobs += skel_jobs
    t1 = time.perf_counter()
    bic_lists = _bic_lists(skeletons, jobs, k_range, workers)
    if stats is not None:
        stats.update(reduce_s=t1 - t0, fits_s=time.perf_counter() - t1,
                     n_fits=len(jobs), workers=workers, skeletons=skeletons)
    s_range = (([] if int(kneedle_s) == kneedle_s else [kneedle_s])
               + list(range(int(kneedle_s), 0, -1)))
    k_list = []
    for bic_list in bic_lists:
        feasible = [i for i, b in enumerate(bic_list) if np.isfinite(b)]
        xs = [k_range[i] for i in feasible]
        ys = [bic_list[i] for i in feasible]
        predict_k = None
        for s in s_range:
            predict_k = kneedle(xs, ys, S=s)
            if predict_k is not None:
                break
        if predict_k is None:
            # degenerate curve: fall back to the best-BIC k
            predict_k = k_range[int(np.argmax(bic_list))]
        k_list.append(predict_k)
    return int(round(float(np.mean(k_list)))), bic_lists, k_range
