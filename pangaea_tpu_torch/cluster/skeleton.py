"""Weighted k-means of the RPH skeleton (<= max_point weighted points).

pangaea_tpu and the reference run ``sklearn.cluster.KMeans(n_clusters,
n_init=10, random_state=seed).fit(X, sample_weight=w)`` here
(rph_kmeans_.py:124-126). The port does not depend on scikit-learn, so
this module reproduces that call in numpy on the host:

- greedy k-means++ seeding with 2 + int(log k) local trials, consuming
  the ``RandomState`` exactly as sklearn's ``_kmeans_plusplus`` does (one
  weighted ``choice``, then one ``uniform(size=trials)`` per center), so
  the same seed picks the same seed points;
- Lloyd iterations on the mean-centred data with sklearn's stopping
  rules: strict convergence when no label changes, else the summed
  squared center shift against ``tol * mean(var(X))``, at most
  ``max_iter``; empty clusters take the points farthest from their
  assigned centers; a final E-step when not strictly converged;
- the best of ``n_init`` runs by inertia, a later run replacing the best
  only when it is lower and not the same partition.

Seeding mirrors sklearn's float32 arithmetic, so it picks sklearn's seed
points; the Lloyd steps run in float64, so centers agree with sklearn's
to float rounding.

:func:`fit_skeletons` runs many such fits, each from its own seed, in a
``spawn`` process pool. This module imports only numpy, so a worker
loads neither torch nor CUDA.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np


def _sqdist(A: np.ndarray, B: np.ndarray, b_sq: np.ndarray) -> np.ndarray:
    d = (A * A).sum(1)[:, None] - 2.0 * A @ B.T + b_sq[None, :]
    return np.maximum(d, 0.0)


def kmeans_plusplus(X: np.ndarray, n_clusters: int, sample_weight: np.ndarray,
                    rng: np.random.RandomState) -> np.ndarray:
    """Indices of the k-means++ seed points (sklearn's greedy variant).
    Like sklearn on float32 data, distances are computed in float64 and
    kept in float32, and the potentials are float32 sums."""
    X32 = np.asarray(X, np.float32)
    w = np.asarray(sample_weight, np.float32)
    X64 = X32.astype(np.float64)
    n = X64.shape[0]
    trials = 2 + int(np.log(n_clusters))
    x_sq = (X64 * X64).sum(1)

    def dist(rows):
        return _sqdist(X64[rows], X64, x_sq).astype(np.float32)

    indices = np.full(n_clusters, -1, dtype=np.int64)
    indices[0] = rng.choice(n, p=w / w.sum())
    closest = dist([indices[0]])
    pot = closest @ w
    for c in range(1, n_clusters):
        rand_vals = rng.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, n - 1, out=cand)
        d = np.minimum(closest, dist(cand))
        cand_pot = d @ w.reshape(-1, 1)
        best = int(np.argmin(cand_pot))
        pot = cand_pot[best]
        closest = d[best]
        indices[c] = cand[best]
    return indices


def _assign(X, centers):
    d = _sqdist(X, centers, (centers * centers).sum(1))
    return np.argmin(d, axis=1)


def _lloyd(X, w, centers, max_iter, tol):
    k = centers.shape[0]
    labels_old = np.full(X.shape[0], -1)
    strict = False
    for _ in range(max_iter):
        labels = _assign(X, centers)
        weight_in = np.bincount(labels, weights=w, minlength=k)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, X * w[:, None])
        empty = np.flatnonzero(weight_in == 0)
        if empty.size:
            dist = ((X - centers[labels]) ** 2).sum(1)
            if dist.max() > 0:
                far = np.argsort(-dist, kind="stable")[:empty.size]
                for new, idx in zip(empty, far):
                    old = labels[idx]
                    sums[old] -= X[idx] * w[idx]
                    sums[new] = X[idx] * w[idx]
                    weight_in[new] = w[idx]
                    weight_in[old] -= w[idx]
        new_centers = centers.copy()
        nz = weight_in > 0
        new_centers[nz] = sums[nz] / weight_in[nz, None]
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    inertia = float((((X - centers[labels]) ** 2).sum(1) * w).sum())
    return centers, labels, inertia


def _same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """sklearn's _is_same_clustering: every label of ``a`` maps to one
    label of ``b``."""
    pairs = np.unique(np.stack([a, b]), axis=1)
    return len(np.unique(pairs[0])) == pairs.shape[1]


def weighted_kmeans(X: np.ndarray, sample_weight: np.ndarray,
                    n_clusters: int, n_init: int = 10, random_state: int = 0,
                    max_iter: int = 300, tol: float = 1e-4
                    ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(centers, labels, inertia) of the best of ``n_init`` runs — the
    result of sklearn's KMeans(n_clusters, n_init=n_init,
    random_state=random_state).fit(X, sample_weight=sample_weight)."""
    rng = np.random.RandomState(random_state)
    X32 = np.asarray(X, np.float32)
    tol_eff = float(np.mean(np.var(X32, axis=0)) * tol)
    mean = X32.mean(axis=0)
    Xc = X32 - mean
    X64 = Xc.astype(np.float64)
    w = np.asarray(sample_weight, np.float32)
    best = None
    for _ in range(n_init):
        idx = kmeans_plusplus(Xc, n_clusters, w, rng)
        centers, labels, inertia = _lloyd(X64, w.astype(np.float64),
                                          X64[idx].copy(), max_iter, tol_eff)
        if best is None or (inertia < best[2]
                            and not _same_partition(labels, best[1])):
            best = (centers, labels, inertia)
    centers, labels, inertia = best
    return centers + mean, labels, inertia


# ---- many fits in a process pool ------------------------------------------

Job = Tuple[int, int, int]  # (skeleton index, n_clusters, random_state)
# BLAS threads per worker: one, since the pool already fills the cores
# and threads only contend on these small matmuls
_BLAS_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# the skeletons, set once in each pool worker by its initializer
_worker_skeletons: Sequence[Tuple[np.ndarray, np.ndarray]] = ()


def _init_worker(skeletons) -> None:
    global _worker_skeletons
    _worker_skeletons = skeletons


def _fit(skeletons, job: Job) -> Tuple[np.ndarray, np.ndarray]:
    s, k, seed = job
    X, w = skeletons[s]
    centers, labels, _ = weighted_kmeans(X, w, k, n_init=10,
                                         random_state=seed)
    return centers, labels


def _fit_job(job: Job) -> Tuple[np.ndarray, np.ndarray]:
    return _fit(_worker_skeletons, job)


def fit_skeletons(skeletons: Sequence[Tuple[np.ndarray, np.ndarray]],
                  jobs: Sequence[Job], workers: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(centers, labels) of :func:`weighted_kmeans` (n_init 10, as
    pangaea_tpu's sklearn call) for every job, in job order.
    ``skeletons`` holds (points, weights) pairs; a job names one by
    index, with its k and seed. ``workers`` <= 1 runs the fits inline;
    more runs them in a ``spawn`` pool of that many processes. Each fit
    depends on its inputs and seed alone, so the results are the same
    with any worker count. A failed worker raises."""
    if workers <= 1 or len(jobs) <= 1:
        return [_fit(skeletons, j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    saved = {v: os.environ.get(v) for v in _BLAS_ENV}
    # a spawned worker reads its BLAS thread count from the environment
    # it starts with; the pool starts its workers while the jobs go in
    os.environ.update({v: "1" for v in _BLAS_ENV})
    try:
        with ProcessPoolExecutor(min(workers, len(jobs)), mp_context=ctx,
                                 initializer=_init_worker,
                                 initargs=(skeletons,)) as pool:
            futures = [pool.submit(_fit_job, j) for j in jobs]
            return [f.result() for f in futures]
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
