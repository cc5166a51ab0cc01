"""RPH-KMeans: skeleton-initialized k-means, best of n_init runs.

Port of pangaea_tpu/cluster/rph.py. Behavior contract (reference
rph_kmeans_.py:116-162 + src/clustering.py:14-19):

- each run: point-reduce X to <= max_point skeleton points; weighted
  KMeans on the skeleton gives init centers; full (unweighted) KMeans
  from those centers; keep the run with the lowest full-data inertia.
- Pangaea invokes RPHKMeans(n_init=20, n_clusters=k).fit_predict(latent)
  (src/clustering.py:17).
- raises if the skeleton ends up smaller than n_clusters
  (rph_kmeans_.py:118-119).

Point reduction and the full-data Lloyd run on the given device; the
skeleton KMeans (<= 2000 weighted points) runs on the host, as in the JAX
package and the reference, through cluster/skeleton.py — a numpy
reproduction of the sklearn KMeans call they make (the port does not
depend on scikit-learn). Unlike the JAX package, small fits are not
routed to the host CPU: step 3 runs where the caller says.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from pangaea_tpu_torch.cluster.kmeans import kmeans_lloyd
from pangaea_tpu_torch.cluster.reduce import RPPointReducer, _nearest_labels
from pangaea_tpu_torch.cluster.skeleton import weighted_kmeans
from pangaea_tpu_torch.utils import DeviceLike, resolve_device

log = logging.getLogger(__name__)


class RPHKMeans:
    def __init__(self, n_clusters: int = 8, n_init: int = 1,
                 w: Optional[float] = None, max_point: int = 2000,
                 proj_num: int = 5, max_iter: int = 1000,
                 sample_dist_num: int = 1000,
                 bkt_improve: Optional[str] = None,
                 radius_divide: Optional[float] = None,
                 bkt_size_keepr: float = 1.0,
                 center_dist_keepr: float = 1.0,
                 skeleton_n_init: int = 10,
                 final_max_iter: int = 300, final_tol: float = 1e-4,
                 random_state: Optional[int] = None, verbose: int = 0,
                 device: DeviceLike = None):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.w = w
        self.max_point = max_point
        self.proj_num = proj_num
        self.max_iter = max_iter
        self.sample_dist_num = sample_dist_num
        self.bkt_improve = bkt_improve
        self.radius_divide = radius_divide
        self.bkt_size_keepr = bkt_size_keepr
        self.center_dist_keepr = center_dist_keepr
        self.skeleton_n_init = skeleton_n_init
        self.final_max_iter = final_max_iter
        self.final_tol = final_tol
        self.rng = np.random.RandomState(random_state)
        self.verbose = verbose
        self.device = resolve_device(device)

        self.cluster_centers_: Optional[np.ndarray] = None
        self.labels_: Optional[np.ndarray] = None
        self.inertia_: float = np.inf
        self.n_iter_: int = 0
        self.reduced_X_: Optional[np.ndarray] = None
        self.reduced_X_weight_: Optional[np.ndarray] = None
        self.init_centers_: Optional[np.ndarray] = None
        self.rp_iter_: int = 0

    def init_centers(self, X: np.ndarray):
        reducer = RPPointReducer(self.w, self.max_point, self.proj_num,
                                 self.max_iter, self.sample_dist_num,
                                 bkt_improve=self.bkt_improve,
                                 radius_divide=self.radius_divide,
                                 bkt_size_keepr=self.bkt_size_keepr,
                                 center_dist_keepr=self.center_dist_keepr,
                                 rng=self.rng, device=self.device)
        reduced_X, weight, labels, rp_iter = reducer.fit_transform(X)
        if len(reduced_X) < self.n_clusters:
            raise RuntimeError(
                "Number of reduced points is too small, please try smaller "
                "w or larger proj_num")
        centers, _, _ = weighted_kmeans(
            reduced_X, weight, self.n_clusters, n_init=self.skeleton_n_init,
            random_state=self.rng.randint(2**31 - 1))
        return centers.astype(np.float32), reduced_X, weight, rp_iter

    def fit(self, X: np.ndarray) -> "RPHKMeans":
        X = np.ascontiguousarray(X, dtype=np.float32)
        self.inertia_ = np.inf
        for i in range(self.n_init):
            init_c, red_x, red_w, rp_iter = self.init_centers(X)
            C, labels, inertia, n_iter = kmeans_lloyd(
                X, init_c, max_iter=self.final_max_iter,
                tol=self.final_tol, device=self.device)
            if self.verbose:
                log.info("rph init %d/%d: inertia %.6g (%d iters)",
                         i + 1, self.n_init, inertia, n_iter)
            if inertia < self.inertia_:
                self.inertia_ = inertia
                self.cluster_centers_ = C
                self.labels_ = labels
                self.n_iter_ = n_iter
                self.init_centers_ = init_c
                self.reduced_X_ = red_x
                self.reduced_X_weight_ = red_w
                self.rp_iter_ = rp_iter
        return self

    def fit_predict(self, X: np.ndarray) -> np.ndarray:
        self.fit(X)
        return self.labels_

    def predict(self, X: np.ndarray) -> np.ndarray:
        dev = self.device
        return _nearest_labels(
            torch.from_numpy(np.asarray(X, np.float32)).to(dev),
            torch.from_numpy(np.asarray(self.cluster_centers_,
                                        np.float32)).to(dev)).cpu().numpy()


def clustering_rph_kmeans(embedding: np.ndarray, k: int,
                          n_init: int = 20,
                          random_state: Optional[int] = None,
                          device: DeviceLike = None) -> np.ndarray:
    """src/clustering.py:14-19: RPHKMeans(n_init=20).fit_predict."""
    clt = RPHKMeans(n_init=n_init, n_clusters=k, random_state=random_state,
                    verbose=0, device=device)
    return clt.fit_predict(embedding)
