"""pangaea_tpu_torch — the PyTorch/CUDA port of pangaea_tpu.

The same pipeline steps 1-4 (barcode features -> VAE latent -> RPH-KMeans
clusters and per-bin reads -> assembly ensemble and final_asm.fa) with the
same artifacts and resume markers, written for one NVIDIA H100. Plain tensor work is PyTorch; every kernel
that pangaea_tpu wrote in Pallas for the TPU is a hand-written CUDA
kernel under ``csrc/`` (built with nvcc at first use).

Every entry point takes an explicit ``device``. It defaults to
``cuda`` and raises when no card is present; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels (the CPU tests do).

This package imports nothing of pangaea_tpu and nothing of JAX: it keeps
its own copies of the host-side code it needs.
"""

__version__ = "0.1.0"

from pangaea_tpu_torch.config import PangaeaConfig  # noqa: F401

_LAZY = {
    "FeatureExtractor": ("pangaea_tpu_torch.features", "FeatureExtractor"),
    "BarcodeDataset": ("pangaea_tpu_torch.model", "BarcodeDataset"),
    "VAE": ("pangaea_tpu_torch.model", "VAE"),
    "VAETrainer": ("pangaea_tpu_torch.model", "VAETrainer"),
    "RPHKMeans": ("pangaea_tpu_torch.cluster", "RPHKMeans"),
    "clustering_rph_kmeans": ("pangaea_tpu_torch.cluster",
                              "clustering_rph_kmeans"),
    "Pipeline": ("pangaea_tpu_torch.pipeline", "Pipeline"),
}


def __getattr__(name):
    """Lazy re-exports of the heavier layers (keep the base import
    light)."""
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
