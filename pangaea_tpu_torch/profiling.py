"""Tracing and metrics: named spans on one clock, per-stage seconds dumped
to ``<output>/metrics.json``, and the profiler trace.

- :class:`span`: a context manager that times a block on
  ``time.perf_counter_ns`` and adds its duration to a per-name total.
  While recording is on (:func:`set_recording`) it also keeps a record
  ``(name, parent, thread id, start_ns, end_ns)``; the parent is the
  innermost span open on the same thread. Inside :func:`trace` it also
  opens a ``torch.profiler.record_function`` range of the same name.
  :func:`take_totals` and :func:`take_records` hand over what was
  gathered since the last take.
- :class:`StageTimer`: seconds per pipeline stage, each stage a span.
- :func:`trace`: context manager around ``torch.profiler.profile`` (CPU
  and, on a card, CUDA activities) that exports a Chrome trace
  (``chrome://tracing`` or Perfetto) when ``PANGAEA_TPU_TRACE=<dir>`` is
  set — the variable pangaea_tpu reads, so one setting serves both
  packages — or a ``trace_dir`` is given; it costs nothing otherwise.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

log = logging.getLogger(__name__)

TRACE_ENV = "PANGAEA_TPU_TRACE"

# (name, parent name or None, thread id, start_ns, end_ns)
Record = Tuple[str, Optional[str], int, int, int]


class _Recorder:
    """The process's span totals and records. Spans close on any thread,
    so every update holds the lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals: Dict[str, int] = {}
        self.records: List[Record] = []
        self.recording = False
        self.tracing = 0  # depth of open trace() blocks
        self.local = threading.local()

    def stack(self) -> List[str]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class span:
    """Times the ``with`` block under ``name``. After the block,
    ``seconds`` holds its duration, which the name's total also got."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "_stack",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.parent: Optional[str] = None
        self.start_ns = self.end_ns = 0
        self._range = None

    def __enter__(self) -> "span":
        stack = self._stack = _REC.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if _REC.tracing:
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._stack.pop()
        with _REC.lock:
            _REC.totals[self.name] = (_REC.totals.get(self.name, 0)
                                      + self.end_ns - self.start_ns)
            if _REC.recording:
                _REC.records.append((self.name, self.parent,
                                     threading.get_ident(), self.start_ns,
                                     self.end_ns))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def set_recording(on: bool) -> None:
    """Keep a record of every span that closes from now on (or stop)."""
    _REC.recording = bool(on)


def take_records() -> List[Record]:
    """The records kept since the last take, in the order they closed."""
    with _REC.lock:
        out, _REC.records = _REC.records, []
    return out


def take_totals() -> Dict[str, float]:
    """Seconds per span name since the last take (recording on or off)."""
    with _REC.lock:
        out, _REC.totals = _REC.totals, {}
    return {k: v / 1e9 for k, v in out.items()}


@dataclass
class StageStats:
    seconds: float = 0.0


class StageTimer:
    """Seconds per pipeline stage; each stage is a span of its name."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[StageStats]:
        st = self.stages.setdefault(name, StageStats())
        s = span(name)
        try:
            with s:
                yield st
        finally:
            st.seconds += s.seconds
            log.info("%s: %.2fs", name, st.seconds)

    def as_dict(self) -> Dict:
        return {name: {"seconds": round(s.seconds, 4)}
                for name, s in self.stages.items()}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)


@contextlib.contextmanager
def trace(name: str = "pangaea", trace_dir: Optional[str] = None):
    """Profile the block when ``PANGAEA_TPU_TRACE`` (or ``trace_dir``) is
    set: CPU activities, plus CUDA kernels and copies when a card is
    present, under one ``name`` range, with every span in the block as a
    range of its own. The Chrome trace lands in the directory as
    ``<name>.<pid>.<ns>.pt.trace.json``; with neither set the block runs
    unprofiled."""
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
                        f"{time.perf_counter_ns()}.pt.trace.json")
    log.info("profiler trace -> %s", path)
    with profile(activities=activities) as prof:
        with record_function(name):
            _REC.tracing += 1
            try:
                yield
            finally:
                _REC.tracing -= 1
    prof.export_chrome_trace(path)
