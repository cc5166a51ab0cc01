"""Long 1-D int32 prefix scans: cummax, cummin_reverse, cumsum.

Port of pangaea_tpu/kernels/scan.py, whose Pallas kernel ``_scan_kernel``
(:72-98, ``pl.pallas_call`` at :115) becomes the hand-written CUDA kernel
in ``csrc/scan.cu`` (see its header for the design and the bound). Each
wrapper checks its input, then:

- for a tensor on the CPU, returns the plain PyTorch version below;
- for a CUDA tensor, launches the kernel on the current stream and adds
  one to its ``launches`` count, or raises. There is no fallback.

The plain versions are the semantics: inclusive scans with identities
INT32_MIN / INT32_MAX / 0, the sum wrapping like int32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pangaea_tpu_torch.kernels import build

_OP_CODES = {"max": 0, "min": 1, "sum": 2}


# ---- plain versions ------------------------------------------------------

def cummax_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def cummin_reverse_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), 0).values.flip(0)


def cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    # dtype pinned: torch promotes an int32 cumsum to int64 by default
    return torch.cumsum(x, 0, dtype=torch.int32)


_PLAIN_FORWARD = {"max": cummax_plain,
                  "min": lambda x: torch.cummin(x, 0).values,
                  "sum": cumsum_plain}


def scan_plain(x: torch.Tensor, op: str, reverse: bool) -> torch.Tensor:
    """Plain version of any of the kernel's six (op, direction) variants."""
    fwd = _PLAIN_FORWARD[op]
    return fwd(x.flip(0)).flip(0) if reverse else fwd(x)


# ---- kernel launch -------------------------------------------------------

def _check(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"scan takes int32, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"scan takes a 1-D tensor, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("scan takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scan runs on cpu or cuda, not {x.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("scan")
    lib.pgs_scan.restype = ctypes.c_int
    lib.pgs_scan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p]
    lib.pgs_scan_scratch_bytes.restype = ctypes.c_longlong
    lib.pgs_scan_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.pgs_scan_tile_elems.restype = ctypes.c_int
    lib.pgs_scan_tile_elems.argtypes = []
    lib.pgs_scan_resources.restype = ctypes.c_int
    lib.pgs_scan_resources.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    return lib


def tile_elems() -> int:
    """Elements per tile (per block) of the CUDA scan."""
    return _lib().pgs_scan_tile_elems()


def kernel_resources(op: str, reverse: bool) -> dict:
    """Registers per thread, spill bytes per thread, shared bytes per
    block and resident blocks per SM of one variant's kernel, as the CUDA
    runtime reports them for the current card."""
    res = (ctypes.c_int * 4)()
    rc = _lib().pgs_scan_resources(_OP_CODES[op], int(reverse), res)
    if rc != 0:
        raise RuntimeError(f"pgs_scan_resources({op}, reverse={reverse}) "
                           f"failed with code {rc}")
    return dict(zip(("regs", "spill_bytes", "smem_bytes", "blocks_per_sm"),
                    res))


def scan_cuda(x: torch.Tensor, op: str, reverse: bool) -> torch.Tensor:
    """Launch the CUDA scan on ``x`` (int32, 1-D, contiguous, on a card;
    any offset into its storage). Output and scratch (tile descriptors,
    zeroed by the library on the stream) are allocated here; the kernel
    allocates nothing and does not synchronise."""
    _check(x)
    if x.device.type != "cuda":
        raise ValueError(f"scan_cuda takes a CUDA tensor, got {x.device}")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        scratch = torch.empty(lib.pgs_scan_scratch_bytes(n),
                              dtype=torch.uint8, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pgs_scan(_OP_CODES[op], int(reverse), x.data_ptr(),
                          out.data_ptr(), n, scratch.data_ptr(),
                          scratch.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"CUDA scan ({op}, reverse={reverse}, n={n}) "
                           f"failed with code {rc}")
    return out


# ---- public wrappers -----------------------------------------------------

def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum."""
    _check(x)
    if x.device.type == "cpu":
        return cummax_plain(x)
    out = scan_cuda(x, "max", reverse=False)
    cummax.launches += 1
    return out


def cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running minimum from the end: out[i] = min(x[i:])."""
    _check(x)
    if x.device.type == "cpu":
        return cummin_reverse_plain(x)
    out = scan_cuda(x, "min", reverse=True)
    cummin_reverse.launches += 1
    return out


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum, wrapping like int32."""
    _check(x)
    if x.device.type == "cpu":
        return cumsum_plain(x)
    out = scan_cuda(x, "sum", reverse=False)
    cumsum.launches += 1
    return out


cummax.launches = 0
cummin_reverse.launches = 0
cumsum.launches = 0

WRAPPERS = (cummax, cummin_reverse, cumsum)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
