"""Adam with torch's coupled L2 in one launch: ``csrc/adam.cu``.

Step 2's CUDA graph (``model/train.py``) steps the VAE with this kernel
in place of ``torch.optim.Adam``. Eager Adam computes each step's bias
corrections on the host, so a captured eager step would replay one step's
scalars; the kernel reads them from a device table through a device step
counter that it advances itself. Its per-element arithmetic is eager
Adam's foreach step on a card, bit for bit (the kernel's header).

- :func:`step_scalars`: the table, one float32 row (``-lr / (1 -
  beta1**t)``, ``(1 - beta2**t) ** 0.5``) per step t = 1, 2, ..., each
  computed in float64 by eager Adam's own expressions and rounded to
  float32 as the foreach kernels round a Python scalar.
- :func:`adam_step_plain`: the same step as eager Adam's foreach calls,
  for CPU tensors; :func:`adam_step` launches the kernel for CUDA
  tensors (or raises).
- :class:`KernelAdam`: takes over a ``torch.optim.Adam``'s moments and
  step count and steps with :func:`adam_step`.

The step state is three int32 on the parameters' device: the steps
taken (the table's row of the next step), the kernel's count of finished
blocks (0 between steps) and an error flag. A step past the table's last
row changes nothing and sets the flag; :meth:`KernelAdam.check` raises on
it.

``adam_step.launches`` counts the kernel's launches that the card runs:
a launch issued by the host counts at once, one recorded into a CUDA
graph counts each time its graph is replayed (:func:`count_replays`,
with the number :func:`adam_step` added to ``adam_step.captured`` while
the graph was captured).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from pangaea_tpu_torch.kernels import build


def step_scalars(lr: float, beta1: float, beta2: float, steps: int
                 ) -> np.ndarray:
    """(steps, 2) float32: row t - 1 holds step t's (step_size,
    bias_correction2_sqrt) as ``torch.optim.adam._multi_tensor_adam``
    computes them (capturable off) and its foreach calls round them."""
    rows = np.empty((steps, 2), np.float32)
    for t in range(1, steps + 1):
        step = float(t)  # _get_value(step): the float of a float32 tensor
        bias_correction1 = 1 - beta1 ** step
        bias_correction2 = 1 - beta2 ** step
        rows[t - 1] = ((lr / bias_correction1) * -1,
                       bias_correction2 ** 0.5)
    return rows


@dataclass(frozen=True)
class Consts:
    """The step's constant scalars, each the float32 that eager Adam's
    foreach call makes of its Python scalar."""

    wd: float   # weight_decay (_foreach_add's alpha)
    w1: float   # 1 - beta1 (_foreach_lerp_'s weight)
    b2: float   # beta2 (_foreach_mul_)
    c2: float   # 1 - beta2 (_foreach_addcmul_'s value)
    eps: float

    @classmethod
    def of(cls, beta1: float, beta2: float, eps: float,
           weight_decay: float) -> "Consts":
        f32 = lambda x: float(np.float32(x))  # noqa: E731
        return cls(f32(weight_decay), f32(1 - beta1), f32(beta2),
                   f32(1 - beta2), f32(eps))


def adam_step_plain(params: List[torch.Tensor], grads: List[torch.Tensor],
                    exp_avgs: List[torch.Tensor],
                    exp_avg_sqs: List[torch.Tensor], rows: torch.Tensor,
                    state: torch.Tensor, c: Consts) -> None:
    """One step, in place, as eager Adam's foreach calls, with the
    scalars of row ``state[0]``; advances ``state[0]``. Past the table's
    last row it changes nothing and sets ``state[2]``, as the kernel."""
    step = int(state[0])
    if not 0 <= step < rows.shape[0]:
        state[2] = 1
        return
    step_size, bc2_sqrt = rows[step].tolist()
    n = len(params)
    g = (torch._foreach_add(grads, params, alpha=c.wd) if c.wd != 0
         else grads)
    torch._foreach_lerp_(exp_avgs, g, c.w1)
    torch._foreach_mul_(exp_avg_sqs, c.b2)
    torch._foreach_addcmul_(exp_avg_sqs, g, g, c.c2)
    d = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_div_(d, [bc2_sqrt] * n)
    torch._foreach_add_(d, c.eps)
    torch._foreach_addcdiv_(params, exp_avgs, d, [step_size] * n)
    state[0] += 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("adam")
    lib.pga_adam_step.restype = ctypes.c_int
    lib.pga_adam_step.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib


# tensors a launch of the kernel takes (kMaxTensors in csrc/adam.cu)
MAX_TENSORS = 64


def launches_of(numel: List[int]) -> int:
    """The kernel's launches for one step over tensors of these sizes:
    one per group of ``MAX_TENSORS`` consecutive tensors that holds an
    element."""
    return sum(any(n > 0 for n in numel[i:i + MAX_TENSORS])
               for i in range(0, len(numel), MAX_TENSORS))


def _check(lists, rows: torch.Tensor, state: torch.Tensor) -> None:
    device = lists[0][0].device
    for ts in lists:
        if len(ts) != len(lists[0]):
            raise ValueError("params, grads and moments differ in length")
        for t, p in zip(ts, lists[0]):
            if t is None:
                raise ValueError("a parameter has no gradient")
            if (t.dtype != torch.float32 or t.device != device
                    or not t.is_contiguous() or t.shape != p.shape):
                raise ValueError("Adam's tensors must be contiguous float32 "
                                 "on one device, shaped as their parameter")
    if (rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != 2
            or not rows.is_contiguous() or rows.device != device):
        raise ValueError("rows: a contiguous (steps, 2) float32 table on "
                         "the parameters' device")
    if (state.dtype != torch.int32 or state.shape != (3,)
            or state.device != device):
        raise ValueError("state: three int32 on the parameters' device")


def adam_step(params, grads, exp_avgs, exp_avg_sqs, rows: torch.Tensor,
              state: torch.Tensor, c: Consts) -> None:
    """One Adam step over every tensor, in place, with the scalars of row
    ``state[0]`` of ``rows``, which it then advances: the plain version
    on the CPU, one launch of the kernel on torch's current stream on a
    card (more only past the kernel's ``MAX_TENSORS`` tensors a
    launch)."""
    _check([params, grads, exp_avgs, exp_avg_sqs], rows, state)
    if params[0].device.type == "cpu":
        adam_step_plain(params, grads, exp_avgs, exp_avg_sqs, rows, state, c)
        return
    n = len(params)
    ptrs = (ctypes.c_uint64 * (4 * n))(*[
        t.data_ptr() for group in zip(params, grads, exp_avgs, exp_avg_sqs)
        for t in group])
    sizes = [p.numel() for p in params]
    numel = (ctypes.c_longlong * n)(*sizes)
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().pga_adam_step(n, ptrs, numel, c.wd, c.w1, c.b2, c.c2,
                                  c.eps, int(c.wd != 0), rows.data_ptr(),
                                  rows.shape[0], state.data_ptr(), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"CUDA Adam step failed with code {rc}")
    if capturing:
        adam_step.captured += launches_of(sizes)
    else:
        adam_step.launches += launches_of(sizes)


adam_step.launches = 0  # launches the card ran (module docstring)
adam_step.captured = 0  # launches recorded into CUDA graphs


def count_replays(captured: int, replays: int = 1) -> None:
    """Count ``replays`` replays of a graph that recorded ``captured``
    of the kernel's launches."""
    adam_step.launches += captured * replays


def reset_launches() -> None:
    adam_step.launches = adam_step.captured = 0


class KernelAdam:
    """The step of a ``torch.optim.Adam`` (one param group, coupled L2,
    no amsgrad, not maximize) continued by :func:`adam_step`: it takes
    over the optimizer's ``exp_avg``, ``exp_avg_sq`` (the same tensors)
    and step count, and holds the table of ``steps`` rows, enough for
    every step the optimizer will take in all."""

    def __init__(self, opt: torch.optim.Adam, steps: int):
        (group,) = opt.param_groups
        if (group["amsgrad"] or group["maximize"]
                or group.get("decoupled_weight_decay", False)):
            raise ValueError("KernelAdam continues plain Adam with coupled "
                             "L2 only")
        self.params = list(group["params"])
        dev = self.params[0].device
        taken = set()
        for p in self.params:
            st = opt.state[p]
            if not st:  # Adam's lazy state, as its first step makes it
                st.update(step=torch.tensor(0.0),
                          exp_avg=torch.zeros_like(p),
                          exp_avg_sq=torch.zeros_like(p))
            taken.add(int(st["step"]))
        if len(taken) != 1:
            raise ValueError(f"parameters at different steps: {taken}")
        self.exp_avgs = [opt.state[p]["exp_avg"] for p in self.params]
        self.exp_avg_sqs = [opt.state[p]["exp_avg_sq"] for p in self.params]
        beta1, beta2 = group["betas"]
        self.consts = Consts.of(beta1, beta2, group["eps"],
                                group["weight_decay"])
        self.rows = torch.from_numpy(
            step_scalars(group["lr"], beta1, beta2, steps)).to(dev)
        self.state = torch.tensor([taken.pop(), 0, 0], dtype=torch.int32,
                                  device=dev)

    def zero_grad(self, set_to_none: bool = True) -> None:
        if not set_to_none:
            raise ValueError("KernelAdam sets gradients to None")
        for p in self.params:
            p.grad = None

    def check(self) -> None:
        """Raise if a step ran past the table (and so changed nothing);
        waits for the card."""
        if int(self.state[2]):
            raise RuntimeError(f"KernelAdam: a step past its table of "
                               f"{self.rows.shape[0]} steps")

    @torch.no_grad()
    def step(self) -> None:
        adam_step(self.params, [p.grad for p in self.params], self.exp_avgs,
                  self.exp_avg_sqs, self.rows, self.state, self.consts)
