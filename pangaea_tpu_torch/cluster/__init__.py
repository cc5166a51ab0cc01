"""Clustering layer: RPH-KMeans and the BIC cluster count (reference:
third_parties/rph_kmeans).

The names below load their modules on first use, so that importing
``cluster.skeleton`` alone (as the k-selection pool's workers do) loads
numpy and not torch.
"""

import importlib

_LAZY = {
    "RPPointReducer": "pangaea_tpu_torch.cluster.reduce",
    "kmeans_lloyd": "pangaea_tpu_torch.cluster.kmeans",
    "kmeans_inertia": "pangaea_tpu_torch.cluster.kmeans",
    "RPHKMeans": "pangaea_tpu_torch.cluster.rph",
    "clustering_rph_kmeans": "pangaea_tpu_torch.cluster.rph",
    "select_k_with_bic": "pangaea_tpu_torch.cluster.k_selection",
    "cal_bic": "pangaea_tpu_torch.cluster.k_selection",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
