"""Tracing and metrics: per-stage wall-clock timing, dumped to
``<output>/metrics.json``, and the profiler trace.

Port of pangaea_tpu/profiling.py:

- :class:`StageTimer`: wall-clock + item counters per pipeline stage,
  logged as ``stage: N items in S s (R items/s)``.
- :func:`trace`: context manager around ``torch.profiler.profile`` (CPU
  and, on a card, CUDA activities) that exports a Chrome trace
  (``chrome://tracing`` or Perfetto) when ``PANGAEA_TPU_TRACE=<dir>`` is
  set — the variable pangaea_tpu reads, so one setting serves both
  packages — or a ``trace_dir`` is given; it costs nothing otherwise.
- :func:`annotate`: a named range in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch

log = logging.getLogger(__name__)

TRACE_ENV = "PANGAEA_TPU_TRACE"


@dataclass
class StageStats:
    seconds: float = 0.0
    items: int = 0
    unit: str = "items"

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class StageTimer:
    """Accumulates per-stage wall time + throughput counters."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items") -> Iterator[StageStats]:
        st = self.stages.setdefault(name, StageStats(unit=unit))
        t0 = time.time()
        try:
            yield st
        finally:
            st.seconds += time.time() - t0
            if st.items:
                log.info("%s: %d %s in %.2fs (%.0f %s/s)", name, st.items,
                         st.unit, st.seconds, st.rate, st.unit)
            else:
                log.info("%s: %.2fs", name, st.seconds)

    def add(self, name: str, items: int, unit: str = "items") -> None:
        self.stages.setdefault(name, StageStats(unit=unit)).items += items

    def as_dict(self) -> Dict:
        return {name: {"seconds": round(s.seconds, 4), "items": s.items,
                       "unit": s.unit, "rate": round(s.rate, 2)}
                for name, s in self.stages.items()}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)


@contextlib.contextmanager
def trace(name: str = "pangaea", trace_dir: Optional[str] = None):
    """Profile the block when ``PANGAEA_TPU_TRACE`` (or ``trace_dir``) is
    set: CPU activities, plus CUDA kernels and copies when a card is
    present, under one ``name`` range. The Chrome trace lands in the
    directory as ``<name>.<pid>.<ns>.pt.trace.json``; with neither set
    the block runs unprofiled."""
    trace_dir = trace_dir or os.environ.get(TRACE_ENV)
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(trace_dir, f"{name}.{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    log.info("profiler trace -> %s", path)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """A named range in the profiler trace (no cost when not tracing
    beyond the range's own bookkeeping)."""
    from torch.profiler import record_function
    with record_function(name):
        yield
