"""Where the card idles, by the program's own spans, in passes of one
benchmark cell; and what recording the spans costs.

    python3 tools/span_idle.py --workload 10x-atcc.bin --seed 7 \
        --pairs 2 --traced 2 --out chiprun_out/span_idle.10x.json

In one process, on the cell's inputs from ``--seed`` (the benchmark's
generator, a warm-up pass first):

1. ``--pairs`` pairs of passes with span recording off and on, in turns
   (off, on, on, off, ...), each pass on the same inputs: the step
   seconds of each, and the cost of one span with recording off and on
   against a bare ``perf_counter`` pair.
2. ``--traced`` passes under ``torch.profiler`` (CUDA activity) with
   recording on. A marker kernel maps the device clock onto the host's,
   as the benchmark's traced window does. For each span name: its
   seconds, and the card's idle seconds inside it; and the longest idle
   gaps, each labelled by the innermost span of the main thread that
   covers its midpoint.

Prints one JSON object and writes it to ``--out``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Busy:
    """The union of the device's busy intervals, asked how much of a
    host interval it covers."""

    def __init__(self, merged):
        self.s = [a for a, _ in merged]
        self.e = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def within(self, a: int, b: int) -> int:
        i = bisect.bisect_right(self.e, a)
        j = bisect.bisect_left(self.s, b)
        if i >= j:
            return 0
        return (self.cum[j] - self.cum[i] - max(0, a - self.s[i])
                - max(0, self.e[j - 1] - b))


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def attribute(events, t0_host: int, records, main_tid: int, top: int = 10):
    """Per span name ``{"n", "s", "idle_s"}`` and the ``top`` longest
    idle gaps as ``[label, seconds]``. ``events`` are the device's
    ``(name, start_ns, end_ns)``; the earliest is the marker launched at
    host time ``t0_host``. ``records`` are the recorder's."""
    events = sorted(events, key=lambda e: e[1])
    offset = events[0][1] - t0_host
    merged = merge((s - offset, e - offset) for _, s, e in events[1:])
    busy = Busy(merged)
    spans = {}
    for name, _, _, s, e in records:
        d = spans.setdefault(name, {"n": 0, "s": 0.0, "idle_s": 0.0})
        d["n"] += 1
        d["s"] += (e - s) / 1e9
        d["idle_s"] += (e - s - busy.within(s, e)) / 1e9
    main = [r for r in records if r[2] == main_tid]
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])), reverse=True)

    def label(t):
        inside = [r for r in main if r[3] <= t <= r[4]]
        return (min(inside, key=lambda r: r[4] - r[3])[0] if inside
                else "outside")

    return spans, [[label((a + b) // 2), d / 1e9] for d, a, b in gaps[:top]]


def span_cost_ns(n: int = 200_000) -> dict:
    """ns per span with recording off and on, and per bare perf_counter
    pair (what the spans replaced)."""
    from pangaea_tpu_torch import profiling
    out = {}
    t = time.perf_counter_ns()
    for _ in range(n):
        a = time.perf_counter()
        _ = time.perf_counter() - a
    out["perf_counter_pair"] = (time.perf_counter_ns() - t) / n
    for on in (False, True):
        profiling.set_recording(on)
        t = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        out["span_" + ("on" if on else "off")] = (
            (time.perf_counter_ns() - t) / n)
        profiling.set_recording(False)
        profiling.take_records()
        profiling.take_totals()
    return out


def _steps(p) -> dict:
    out = dict(p.stages)
    if p.step0_s:
        out["step0"] = sum(p.step0_s.values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="span_idle")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--traced", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from benchmark import harness, run
    run.cache_env(ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pangaea_tpu_torch import profiling
    if not torch.cuda.is_available():
        print("span_idle needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(ROOT, args.workload)
    work = tempfile.mkdtemp(prefix="span-idle-")
    lloyd = harness.Step3Counts()
    res = {"workload": cell.name, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "power_limit": run._power_limit()}
    n = 0

    def one_pass(inp):
        nonlocal n
        out = os.path.join(work, f"pass{n}")
        n += 1
        p = harness.run_pass(cell, inp, out, "cuda", lloyd)
        torch.cuda.synchronize()
        lloyd.take()
        shutil.rmtree(out)
        return p

    try:
        inp, warm = harness.make_inputs(cell, args.seed, work)
        one_pass(warm)
        res["span_cost_ns"] = span_cost_ns()
        passes = []
        for i in range(2 * args.pairs):
            on = i % 4 in (1, 2)
            profiling.take_totals()
            profiling.set_recording(on)
            p = one_pass(inp)
            profiling.set_recording(False)
            passes.append({"recording": on, "seconds": p.seconds,
                           "steps": _steps(p),
                           "records": len(profiling.take_records())})
        res["passes"] = passes
        for key in ("seconds", "records"):
            res[key + "_median"] = {
                mode: statistics.median(q[key] for q in passes
                                        if q["recording"] == on)
                for mode, on in (("off", False), ("on", True))}

        profiling.take_records()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        torch.ones(1, device="cuda").add_(1)  # the clock marker
        torch.cuda.synchronize()
        profiling.set_recording(True)
        try:
            traced = [one_pass(inp) for _ in range(args.traced)]
        finally:
            profiling.set_recording(False)
            t1 = time.perf_counter_ns()
            prof.__exit__(None, None, None)
        records = profiling.take_records()
        events = harness._events(prof)
        spans, gaps = attribute(events, t0, records, threading.get_ident())
        merged = merge((s, e) for _, s, e in sorted(
            events, key=lambda e: e[1])[1:])
        busy_s = sum(e - s for s, e in merged) / 1e9
        res["traced"] = {
            "passes": len(traced), "window_s": (t1 - t0) / 1e9,
            "busy_s": busy_s, "records": len(records),
            "spans": {k: dict(v, idle_pct=100 * v["idle_s"] / v["s"]
                              if v["s"] else None)
                      for k, v in sorted(spans.items())},
            "idle_gaps": gaps,
            "steps": [_steps(p) for p in traced]}
    finally:
        lloyd.close()
        shutil.rmtree(work, ignore_errors=True)
    text = json.dumps(res)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
