"""PyTorch port's scans vs the Pallas scan kernel (interpret mode on CPU).

On the CPU the port's wrappers run their plain PyTorch versions; these
must be bit-equal to pangaea_tpu's Pallas kernel for every op at awkward
lengths (sub-block, exact block, multi-block, non-multiples), including
the wrapping int32 sum and the reverse min. The CUDA kernel itself is
checked against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from pangaea_tpu.kernels.scan import _BLOCK, _scan1d_pallas
from pangaea_tpu_torch.kernels import scan

LENGTHS = [1, 7, 129, _BLOCK - 1, _BLOCK, _BLOCK + 1, 3 * _BLOCK + 12345]
_FORWARD = {"max": scan.cummax, "sum": scan.cumsum}


def _input(n, op, seed):
    rng = np.random.RandomState(seed)
    if op == "sum":  # full int32 range: the sum wraps
        return rng.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64) \
            .astype(np.int32)
    return rng.randint(-2 ** 30, 2 ** 30, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("n", LENGTHS)
def test_forward_scan_matches_pallas(op, n):
    x = _input(n, op, seed=n * 31 + len(op))
    want = np.asarray(_scan1d_pallas(x, op, interpret=True))
    got = _FORWARD[op](torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("n", [1, 129, _BLOCK + 1])
def test_scan_plain_variants_match_pallas(op, n):
    """The plain version of every (op, direction) variant the CUDA kernel
    offers: forward is the Pallas scan, reverse is flip -> scan -> flip."""
    x = _input(n, op, seed=n * 7 + len(op))
    fwd = np.asarray(_scan1d_pallas(x, op, interpret=True))
    rev = np.flip(np.asarray(_scan1d_pallas(np.flip(x).copy(), op,
                                            interpret=True)))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(scan.scan_plain(t, op, False).numpy(), fwd)
    np.testing.assert_array_equal(scan.scan_plain(t, op, True).numpy(), rev)


@pytest.mark.parametrize("n", LENGTHS)
def test_cummin_reverse_matches_pallas(n):
    """The TPU's reverse scan is flip -> Pallas forward -> flip."""
    x = _input(n, "min", seed=n * 17)
    want = np.flip(np.asarray(_scan1d_pallas(np.flip(x).copy(), "min",
                                             interpret=True)))
    got = scan.cummin_reverse(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


_I32 = np.iinfo(np.int32)


def _adversarial(kind, n):
    if kind == "constant":
        return np.full(n, 12345, np.int32)
    if kind == "increasing":
        return (np.arange(n, dtype=np.int64) - n // 2).astype(np.int32)
    if kind == "decreasing":
        return (n // 2 - np.arange(n, dtype=np.int64)).astype(np.int32)
    return np.full(n, {"int_min": _I32.min, "int_max": _I32.max}[kind],
                   np.int32)


@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("kind", ["constant", "increasing", "decreasing",
                                  "int_min", "int_max"])
def test_scan_plain_adversarial_inputs_match_pallas(op, kind):
    """Constant, monotone and all-extreme inputs (the extremes are the
    identities of max and min; their sums wrap) in both directions."""
    x = _adversarial(kind, 2 * _BLOCK + 5)
    fwd = np.asarray(_scan1d_pallas(x, op, interpret=True))
    rev = np.flip(np.asarray(_scan1d_pallas(np.flip(x).copy(), op,
                                            interpret=True)))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(scan.scan_plain(t, op, False).numpy(), fwd)
    np.testing.assert_array_equal(scan.scan_plain(t, op, True).numpy(), rev)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("name,op,reverse", [("cummax", "max", False),
                                             ("cummin_reverse", "min", True),
                                             ("cumsum", "sum", False)])
def test_wrappers_take_misaligned_views(name, op, reverse, offset):
    """A contiguous view that starts inside its storage (x[1:], x[3:]:
    not 16-byte aligned) goes through each wrapper."""
    base = _input(_BLOCK + 9, op, seed=offset * 101 + len(name))
    view = torch.from_numpy(base)[offset:]
    assert view.is_contiguous() and view.storage_offset() == offset
    x = base[offset:].copy()
    if reverse:
        want = np.flip(np.asarray(_scan1d_pallas(np.flip(x).copy(), op,
                                                 interpret=True)))
    else:
        want = np.asarray(_scan1d_pallas(x, op, interpret=True))
    np.testing.assert_array_equal(getattr(scan, name)(view).numpy(), want)


def test_empty_input():
    x = torch.zeros(0, dtype=torch.int32)
    for fn in scan.WRAPPERS:
        assert fn(x).shape == (0,)


@pytest.mark.parametrize("bad", [
    torch.zeros(8, dtype=torch.int64),
    torch.zeros(8, dtype=torch.float32),
    torch.zeros((2, 4), dtype=torch.int32),
    torch.zeros(16, dtype=torch.int32)[::2],
])
def test_wrappers_reject_bad_input(bad):
    for fn in scan.WRAPPERS:
        with pytest.raises((TypeError, ValueError)):
            fn(bad)


def test_cpu_path_counts_no_launch():
    scan.reset_launches()
    scan.cummax(torch.arange(10, dtype=torch.int32))
    assert all(fn.launches == 0 for fn in scan.WRAPPERS)


def test_scan_cuda_refuses_cpu_tensor():
    with pytest.raises(ValueError):
        scan.scan_cuda(torch.arange(10, dtype=torch.int32), "max", False)
