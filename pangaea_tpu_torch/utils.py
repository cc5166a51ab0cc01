"""Device selection and run set-up shared by the port's entry points,
and glibc's ``rand()`` for hybrid mode's virtual barcodes."""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import tempfile
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class GlibcRand:
    """Bit-exact replica of glibc's ``rand()`` (TYPE_3 additive-feedback
    generator, the default for ``srand``/``rand``).

    Copied from pangaea_tpu.utils. Used to reproduce the reference's
    virtual-barcode draws byte-for-byte: add_barcode seeds
    ``srand(2023)`` (src/cpptools/add_barcode.cpp:105) and consumes one
    ``rand() % n`` per read group with >=1 qualifying alignment (:71-72). The reference runs that loop
    under OpenMP, where ``rand()`` interleaving is nondeterministic; this
    replica matches the OMP_NUM_THREADS=1 stream, which is the only
    deterministic ordering the reference itself has.

    Algorithm (glibc stdlib/random_r.c): 31-word state seeded by a
    Park-Miller LCG via Schrage's method, recurrence
    ``r[i] = (r[i-31] + r[i-3]) mod 2^32`` with the first 310 outputs
    discarded; each output is ``r[i] >> 1``. Verified against compiled C
    by tests/test_hybrid_e2e.py::test_glibc_rand_matches_libc (and the
    port's copy by tests/test_torch_step0.py).
    """

    def __init__(self, seed: int) -> None:
        word = (seed & 0xFFFFFFFF) or 1
        if word >= 0x80000000:
            word -= 0x100000000
        r = [word]
        for _ in range(30):
            # Schrage step with C semantics: glibc computes hi/lo with
            # truncating division (random_r.c seeds via `long int`), which
            # differs from Python's floor divmod when word is negative —
            # i.e. for seeds >= 2^31, whose initial word is a negative
            # int32. Only the first iteration can see word < 0 (the step
            # maps into [0, 2^31) afterwards).
            if word < 0:
                hi = -(-word // 127773)
                lo = word - hi * 127773
            else:
                hi, lo = divmod(word, 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r.append(word)
        r += r[:3]
        for i in range(34, 344):
            r.append((r[i - 31] + r[i - 3]) & 0xFFFFFFFF)
        self._r = r[-31:]
        self._i = 0

    def rand(self) -> int:
        r, i = self._r, self._i
        val = (r[i] + r[i - 3]) & 0xFFFFFFFF
        r[i] = val
        self._i = (i + 1) % 31
        return val >> 1


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. A CUDA device without a card raises — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def setup_numerics() -> None:
    """Full float32 matmuls and convolutions on the card: TF32 keeps
    about three decimal digits, and the reference VAE computes in
    float32. Both flags are set explicitly rather than left to the
    defaults (cuDNN's default is TF32 on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_all(seed: int, threads: int, logfile: str, level: int,
             outdir: str) -> None:
    """src/utils.py:84-105: seed numpy, create outdir, root logger to
    file + stderr with the reference's timestamp format."""
    import numpy as np
    np.random.seed(seed)
    if threads > 0:
        torch.set_num_threads(threads)
    os.makedirs(outdir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter("%(asctime)s (%(levelname)s): %(message)s",
                            "%Y-%m-%d %H:%M:%S")
    for handler in (logging.FileHandler(os.path.join(outdir, logfile)),
                    logging.StreamHandler()):
        handler.setLevel(level)
        handler.setFormatter(fmt)
        root.addHandler(handler)
    root.info("program start up")


@contextlib.contextmanager
def replacing(path: str) -> Iterator[str]:
    """Write-then-rename: yields a unique temp name in ``path``'s
    directory, renamed onto ``path`` when the block ends and removed if
    it raises. A crash mid-write leaves no partial file for an existence
    check to trust, and two writers of one path never share a temp file."""
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp",
                               dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        yield tmp
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def which(tool: str) -> Optional[str]:
    """The path of ``tool`` on PATH, or None."""
    return shutil.which(tool)


def cpu_count() -> int:
    """CPUs this process may run on: ``os.cpu_count()`` less any CPUs its
    affinity mask excludes (what Python 3.13's ``os.process_cpu_count``
    returns)."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1
