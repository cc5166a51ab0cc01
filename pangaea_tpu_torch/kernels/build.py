"""Builds the port's native libraries at first use and loads them.

Two routes share one build step:

- the hand-written CUDA kernels, ``csrc/<name>.cu``, compiled by ``nvcc``
  for ``sm_90a`` into ``build/kernels`` (:func:`load`);
- host C++ with a plain C interface, such as the FASTQ reader
  ``native/fastq_reader.cpp``, compiled by ``g++`` against zlib into
  ``build/native`` (:func:`load_host`).

Each source becomes its own shared library, loaded with ``ctypes``.
Libraries are named by a hash of their source, so an edited source is
rebuilt and a stale library is never loaded, and each is written under a
unique temporary name and then renamed, so concurrent builders never see
a partial file. ``build/`` sits beside the package and ``.gitignore``
lists it. A failed build raises with the compiler's output: there is no
fallback.

Nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, List

from pangaea_tpu_torch.utils import replacing

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE), "build")
BUILD_DIR = os.path.join(BUILD_ROOT, "kernels")
HOST_BUILD_DIR = os.path.join(BUILD_ROOT, "native")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with the CUDA toolkit at first use")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native FASTQ reader is built "
                           "from native/fastq_reader.cpp at first use")
    return cxx


def _build(src: str, name: str, out_dir: str,
           command: Callable[[str], List[str]]) -> ctypes.CDLL:
    """Load ``lib<name>_<digest>.so`` from ``out_dir``, first running
    ``command(tmp_path)`` to build it from ``src`` if it is missing."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(out_dir, f"lib{name}_{digest}.so")
    lib = _loaded.get(out)
    if lib is not None:
        return lib
    if not os.path.isfile(out):
        os.makedirs(out_dir, exist_ok=True)
        with replacing(out) as tmp:
            cmd = command(tmp)
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"build of {name} failed "
                                   f"({res.returncode}):\n{' '.join(cmd)}\n"
                                   f"{res.stdout}{res.stderr}")
    lib = _loaded[out] = ctypes.CDLL(out)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    src = os.path.join(CSRC, name + ".cu")
    return _build(src, name, BUILD_DIR,
                  lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src])


def load_host(src: str, name: str) -> ctypes.CDLL:
    """The loaded library of the host C++ source ``src`` (linked with
    zlib), built first if needed."""
    return _build(src, name, HOST_BUILD_DIR,
                  lambda tmp: [_cxx(), *CXX_FLAGS, src, "-o", tmp, "-lz"])
