"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m benchmark.run --workload 10x-atcc.bin --seed 7 --seconds 40 --trace 0

Set-up makes the cell's inputs from ``--seed``, builds or loads the
program's kernels (under ``build/`` in the checkout) and runs one warm-up
pass on a slice of the inputs. The window then runs whole passes, each a
fresh job in a new directory, until ``--seconds`` have elapsed; the pass
running at that moment ends the window. After it, the plain reference
works every answer out again and each pass's outputs are compared with
it.

Standard output ends with a line that lists each pass's work, then the
result line: ``correct``, ``attempted`` and ``failed`` passes, the
metrics (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number beside its limit, which
also end standard error. Without enough CUDA cards the run exits 3 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pangaea_tpu")


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program itself builds its kernels under ``build/``)."""
    base = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main(argv=None, *, root: str = ROOT, device: str = "cuda",
         t_start: float = T_START) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env(root)
    import torch
    from benchmark import harness

    cell = harness.load_cell(root, args.workload)
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    metrics = cell.per_layer if args.trace else cell.end_to_end
    readers = {m["name"]: harness.reader(root, m) for m in metrics}
    work = tempfile.mkdtemp(prefix="pangaea-bench-")
    lloyd = harness.Step3Counts()
    try:
        inp, warm = harness.make_inputs(cell, args.seed, work)
        harness.run_pass(cell, warm, os.path.join(work, "warmup"), device,
                         lloyd)
        lloyd.take()
        shutil.rmtree(os.path.join(work, "warmup"))
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        run = harness.run_window(cell, inp, work, args.seconds, device,
                                 lloyd, bool(args.trace), t_start)
        peak = run.memory_peak_bytes
        bad = forbidden_modules()
        if bad:
            print("the run loaded " + ", ".join(bad), file=sys.stderr)
            return 4
        print(json.dumps({"work": [ps.work() for ps in run.passes]}))
        sys.stdout.flush()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        compared, failed = harness.check(run, inp, device)
        print(f"reference and comparison: "
              f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    finally:
        lloyd.close()
        shutil.rmtree(work, ignore_errors=True)

    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_name,
           "count": cell.chips, "memory_peak_bytes": peak,
           "power_limit": _power_limit() if cuda else "none"}
    result = {"correct": failed == 0, "attempted": len(run.passes),
              "failed": failed, "metrics": values, "device": dev}
    if run.trace is not None:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        ops = sorted(t.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:64], v] for k, v in ops],
                               "idle_gaps": t.idle_gaps}
    result["compared"] = {k: {"value": _finite(c["value"]),
                              "limit": c["limit"]}
                          for k, c in compared.items()}
    sys.stdout.flush()
    for k, c in compared.items():
        print(f"compared {k} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
