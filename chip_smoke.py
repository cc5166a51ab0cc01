#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (pangaea_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each fatal on failure:

1. build    — compile the scan kernel from pangaea_tpu_torch/csrc/
              and print the build seconds, the card's name and power
              limit, and each variant's registers, spills, shared memory
              and resident blocks per SM.
2. kernels  — every op and direction of the CUDA scan against its plain
              PyTorch version on the card, bit-equal at awkward lengths
              (the kernel's tile edges T-1, T, T+1 and 33T+1 among them),
              on misaligned views (x[1:], x[3:]), on adversarial inputs
              (constant, monotone, all INT32_MIN / INT32_MAX, a wrapping
              sum) and at n = 2^28 (the sort-join window cap), with the
              kernel's, the plain version's and the library call's
              times at the cap.
   repeat   — each of the six variants 50 times on one input of 2^24+13
              elements, every result bit-equal (a memory-ordering fault
              in the look-back shows only now and then).
3. pipeline — the port's steps 1-3 (FASTQ -> features -> VAE latent ->
              clusters.tsv -> per-bin reads) on cuda, at the bench.py
              geometry of 800k reads (8 species x 200 kb, 10k barcodes x
              40 pairs, seed 7). Every kernel launch count is zeroed just
              before and read just after; each kernel of the path must
              have launched. ARI vs the simulator's truth must reach 0.5.
4. exact    — step 1 again with device="cpu" (the plain versions) on the
              same FASTQ: abundance and TNF matrices and the barcode
              order must be byte-equal to the card's.

After phase 3, the main path's two wrappers are timed at its scan
length. Every time is the median CUDA-event time of one call. A JSON
line gives copy_ms, the time of one device-to-device copy of the same
int32 bytes at each measured length (the achievable-bandwidth
yardstick beside the bound). The line before the last is one JSON
object with every kernel (name, route, source, the TPU kernel it
replaces, launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms): cummax and cummin_reverse at the main path's length,
cumsum, which the main path does not run, at 2^28. The last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when there is no CUDA card or the
package is missing. Scratch data goes to build/smoke (git-ignored).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# 32-bit rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12

SCAN_CAP = 1 << 28          # FeatureConfig.sortjoin_max_windows
# awkward lengths: the old 4096-element tiles, the Pallas block of 32768
SCAN_LENGTHS = [1, 7, 4095, 4096, 4097, 32767, 32768, 32769,
                3 * 32768 + 12345, 4096 * 4096 + 1]
VARIANTS = [(op, rev) for op in ("max", "min", "sum") for rev in (False, True)]
I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1
REPEAT_N, REPEATS = (1 << 24) + 13, 50


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of one call (inputs far exceed the 50 MB
    L2, so every call starts cold)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scan_bound_ms(n: int) -> tuple:
    """Least time for an n-element int32 scan: 8 bytes per element (one
    read, one write) over HBM bandwidth vs one op per element."""
    t_bytes = 8.0 * n / HBM_BYTES_PER_S * 1e3
    t_ops = float(n) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 1 -------------------------------------------------------------

def phase_build() -> None:
    from pangaea_tpu_torch.kernels import build, scan
    t0 = time.perf_counter()
    build.load("scan")
    log(f"build: scan.cu in {time.perf_counter() - t0:.3f} s into "
        f"{build.BUILD_DIR}; tile {scan.tile_elems()} elements")
    for op, rev in VARIANTS:
        res = scan.kernel_resources(op, rev)
        log(f"build: scan ({op}, reverse={rev}): {res}")
        if res["spill_bytes"] != 0 or res["blocks_per_sm"] < 1:
            raise AssertionError(f"scan ({op}, reverse={rev}) spills or "
                                 f"cannot launch: {res}")


# ---- phase 2 -------------------------------------------------------------

SCAN_OPS = (  # (wrapper name, op)
    ("cummax", "max"),
    ("cummin_reverse", "min"),
    ("cumsum", "sum"),
)


def _scan_input(n: int, op: str, gen, device):
    import torch
    if op == "sum":
        # full int32 range: the sum wraps, which must match bit for bit
        lo, hi = -(2 ** 31), 2 ** 31 - 1
    else:
        lo, hi = -(2 ** 30), 2 ** 30
    return torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int64,
                         device=device).to(torch.int32)


def _plain_and_library(name: str):
    import torch
    from pangaea_tpu_torch.kernels import scan
    plain = {"cummax": scan.cummax_plain,
             "cummin_reverse": scan.cummin_reverse_plain,
             "cumsum": scan.cumsum_plain}[name]
    library = {"cummax": lambda x: torch.cummax(x, 0),
               "cummin_reverse": None,  # no single call scans in reverse
               "cumsum": lambda x: torch.cumsum(x, 0, dtype=torch.int32)
               }[name]
    return plain, library


def copy_ms(n: int) -> float:
    """One device-to-device copy of n int32: the achievable-bandwidth
    yardstick beside a scan's bound."""
    import torch
    x = torch.zeros(n, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(x)
    return time_ms(lambda: dst.copy_(x))


def scan_measure(name: str, op: str, n: int, seed: int) -> dict:
    """Kernel vs plain version on one n-element input: exactness and
    times (kernel, plain, library call, bound)."""
    import torch
    from pangaea_tpu_torch.kernels import scan
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _scan_input(n, op, gen, "cuda")
    plain, library = _plain_and_library(name)
    wrapper = getattr(scan, name)
    got = wrapper(x)
    want = plain(x)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        raise AssertionError(f"{name} n={n}: kernel != plain "
                             f"(max abs err {err})")
    del got, want
    ms = time_ms(lambda: wrapper(x))
    plain_ms = time_ms(lambda: plain(x))
    lib_ms = time_ms(lambda: library(x)) if library is not None else None
    bound, bound_by = scan_bound_ms(n)
    return {"n": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by}


def log_measure(name: str, r: dict) -> None:
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    log(f"kernels: {name} n={r['n']} bit-equal; kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound")


def check_variant(x, op: str, reverse: bool, what: str) -> None:
    import torch
    from pangaea_tpu_torch.kernels import scan
    got = scan.scan_cuda(x, op, reverse)
    torch.cuda.synchronize()
    if not torch.equal(got, scan.scan_plain(x, op, reverse)):
        raise AssertionError(f"scan_cuda({op}, reverse={reverse}) != plain "
                             f"on {what} (n={x.numel()})")


def adversarial_inputs(n: int) -> dict:
    import torch
    ramp = torch.arange(-(n // 2), n - n // 2, dtype=torch.int32,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    return {
        "constant": torch.full((n,), 12345, dtype=torch.int32,
                               device="cuda"),
        "increasing": ramp,
        "decreasing": ramp.flip(0),
        "all INT32_MIN": torch.full((n,), I32_MIN, dtype=torch.int32,
                                    device="cuda"),
        "all INT32_MAX": torch.full((n,), I32_MAX, dtype=torch.int32,
                                    device="cuda"),
        # full int32 range: every sum wraps many times
        "full range": torch.randint(I32_MIN, I32_MAX, (n,), generator=gen,
                                    dtype=torch.int64,
                                    device="cuda").to(torch.int32),
    }


def phase_kernels() -> dict:
    import torch
    from pangaea_tpu_torch.kernels import scan
    gen = torch.Generator(device="cuda").manual_seed(0)
    tile = scan.tile_elems()
    lengths = sorted(set(SCAN_LENGTHS + [tile - 1, tile, tile + 1,
                                         33 * tile + 1]))
    for name, op in SCAN_OPS:
        plain, _ = _plain_and_library(name)
        for n in [0] + lengths:
            x = _scan_input(n, op, gen, "cuda")
            got = getattr(scan, name)(x)
            torch.cuda.synchronize()
            if not torch.equal(got, plain(x)):
                raise AssertionError(f"{name}: kernel != plain at n={n}")
        log(f"kernels: {name} bit-equal at n in {[0] + lengths}")
    # every (op, direction) variant, the wrappers' among them
    for op, reverse in VARIANTS:
        for n in [0] + lengths:
            check_variant(_scan_input(n, op, gen, "cuda"), op, reverse,
                          "random input")
    log(f"kernels: all six (op, direction) variants bit-equal at n in "
        f"{[0] + lengths}")
    for offset in (1, 3):
        for n in (1, 7, tile - 1, tile + 3, 33 * tile + 1):
            base = _scan_input(n + offset, "sum", gen, "cuda")
            view = base[offset:]
            if not view.is_contiguous() or view.data_ptr() % 16 == 0:
                raise AssertionError("x[offset:] is not a misaligned view")
            for op, reverse in VARIANTS:
                check_variant(view, op, reverse, f"x[{offset}:]")
    log("kernels: all six variants bit-equal on misaligned views x[1:], "
        "x[3:]")
    n_adv = 33 * tile + 7
    inputs = adversarial_inputs(n_adv)
    for what, x in inputs.items():
        for op, reverse in VARIANTS:
            check_variant(x, op, reverse, what)
    log(f"kernels: all six variants bit-equal on adversarial inputs "
        f"(n={n_adv}): {', '.join(inputs)}")
    at_cap = {}
    for i, (name, op) in enumerate(SCAN_OPS):
        at_cap[name] = r = scan_measure(name, op, SCAN_CAP, seed=100 + i)
        log_measure(name, r)
        torch.cuda.empty_cache()
    # the variants no wrapper runs, at the cap too
    for op, reverse in (("max", True), ("min", False), ("sum", True)):
        check_variant(_scan_input(SCAN_CAP, op, gen, "cuda"), op, reverse,
                      "random input")
        torch.cuda.empty_cache()
    log("kernels: all six variants bit-equal at n=2^28")
    return at_cap


def phase_repeat() -> None:
    """Each variant REPEATS times on one input: every result bit-equal."""
    import torch
    from pangaea_tpu_torch.kernels import scan
    gen = torch.Generator(device="cuda").manual_seed(50)
    x = torch.randint(I32_MIN, I32_MAX, (REPEAT_N,), generator=gen,
                      dtype=torch.int64, device="cuda").to(torch.int32)
    for op, reverse in VARIANTS:
        want = scan.scan_plain(x, op, reverse)
        for i in range(REPEATS):
            got = scan.scan_cuda(x, op, reverse)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"scan_cuda({op}, reverse={reverse}) "
                                     f"repeat {i} differs at n={REPEAT_N}")
    log(f"repeat: all six variants bit-equal in {REPEATS} runs each at "
        f"n={REPEAT_N}")


# ---- phase 3 -------------------------------------------------------------

SIM = dict(n_species=8, genome_len=200_000, n_barcodes=10_000,
           pairs_per_barcode=40, read_len=150, seed=7)
N_CLUSTERS = 8
ARI_GATE = 0.5
# every kernel: (wrapper, op, TPU kernel replaced); the main path runs
# the first two
KERNELS = (
    ("cummax", "max",
     "pangaea_tpu/kernels/scan.py:72 (_scan_kernel via cummax :153)"),
    ("cummin_reverse", "min",
     "pangaea_tpu/kernels/scan.py:72 (_scan_kernel via cummin_reverse "
     ":157)"),
    ("cumsum", "sum",
     "pangaea_tpu/kernels/scan.py:72 (_scan_kernel via cumsum :161)"),
)
PATH_KERNELS = KERNELS[:2]


def smoke_dir() -> str:
    d = os.path.join(HERE, "build", "smoke")
    os.makedirs(d, exist_ok=True)
    return d


def sim_data() -> tuple:
    """The bench.py FASTQ (800k reads), made from its seed; reused
    when build/smoke already holds it for the same arguments."""
    from pangaea_tpu_torch.io.sim import simulate_linked_reads
    d = os.path.join(smoke_dir(), "data")
    os.makedirs(d, exist_ok=True)
    fq = os.path.join(d, "reads.fq.gz")
    meta = os.path.join(d, "truth.json")
    if os.path.exists(meta):
        with open(meta) as f:
            saved = json.load(f)
        if saved["sim"] == SIM and os.path.exists(fq):
            log(f"pipeline: reusing {fq}")
            return fq, saved["barcode_species"]
    t0 = time.perf_counter()
    tmp = fq + ".tmp.gz"
    res = simulate_linked_reads(out_interleaved=tmp, **SIM)
    os.replace(tmp, fq)
    with open(meta, "w") as f:
        json.dump({"sim": SIM, "barcode_species": res.barcode_species}, f)
    log(f"pipeline: simulated {2 * res.n_pairs} reads in "
        f"{time.perf_counter() - t0:.1f} s")
    return fq, res.barcode_species


def read_clusters(tsv: str) -> dict:
    out = {}
    with open(tsv) as f:
        for line in f:
            cid, bcs = line.rstrip("\n").split("\t")
            for bc in bcs.split(","):
                out[bc] = int(cid)
    return out


def phase_pipeline(fq: str, truth: dict) -> dict:
    import numpy as np
    import torch
    from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
    from pangaea_tpu_torch.config import ClusterConfig, PangaeaConfig
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished
    out = os.path.join(smoke_dir(), "run")
    shutil.rmtree(out, ignore_errors=True)
    cfg = PangaeaConfig(interleaved_reads=fq, output=out, steps="1,2,3",
                        cluster=ClusterConfig(n_clusters=N_CLUSTERS))
    pipe = Pipeline(cfg, device="cuda")
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in scan.WRAPPERS}
    for step in ("1", "2", "3"):
        if not check_step_finished(out, step):
            raise AssertionError(f"step {step} left no marker")
    for name, *_ in PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    stats = dict(pipe.feature_extractor.stats)
    steps = {k: v.seconds for k, v in pipe.timer.stages.items()}
    clusters = read_clusters(os.path.join(out, "3.clustering",
                                          "clusters.tsv"))
    labelled = [bc for bc in clusters if bc in truth]
    ari = adjusted_rand_score([truth[bc] for bc in labelled],
                              [clusters[bc] for bc in labelled])
    bins = sorted(f for f in os.listdir(os.path.join(out, "3.clustering"))
                  if f.endswith(".fq"))
    latent = np.load(os.path.join(out, "2.vae", "latent.npz"))["arr_0"]
    log(f"pipeline: steps 1-3 on cuda in {wall:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()))
    log(f"pipeline: step-1 phases: stream {stats['stream_s']:.3f} s, "
        f"sort-join {stats['sortjoin_s']:.3f} s, replay "
        f"{stats['replay_s']:.3f} s; {stats['windows']} windows, "
        f"{stats['sorted_windows']} sorted")
    log(f"pipeline: scan launches {launches}; {len(clusters)} barcodes "
        f"clustered, latent {latent.shape}, {len(bins)} bin FASTQs; "
        f"ARI vs truth {ari:.6f} on {len(labelled)} labelled barcodes")
    if not (latent.ndim == 2 and latent.shape[1] == cfg.model.latent_dim
            and np.isfinite(latent).all()):
        raise AssertionError(f"bad latent {latent.shape}")
    if len(bins) != len(set(clusters.values())):
        raise AssertionError(f"{len(bins)} bin FASTQs for "
                             f"{len(set(clusters.values()))} clusters")
    if ari < ARI_GATE:
        raise AssertionError(f"ARI {ari} below {ARI_GATE}")
    return {"out": out, "wall_s": wall, "steps": steps, "stats": stats,
            "launches": launches, "ari": ari, "n_barcodes": len(clusters),
            "feature_dir": pipe.feature_dir}


# ---- phase 4 -------------------------------------------------------------

def phase_exact(fq: str, feature_dir: str) -> None:
    """Step 1 with the plain versions on the CPU must reproduce the
    card's feature files byte for byte."""
    import gzip
    from pangaea_tpu_torch.config import FeatureConfig
    from pangaea_tpu_torch.features import FeatureExtractor
    cpu_dir = os.path.join(smoke_dir(), "cpu_features")
    shutil.rmtree(cpu_dir, ignore_errors=True)
    t0 = time.perf_counter()
    fe_cpu = FeatureExtractor(FeatureConfig(), cpu_dir, device="cpu")
    names, abd, tnf = fe_cpu.extract_features(interleaved=fq)
    secs = time.perf_counter() - t0
    fe_gpu = FeatureExtractor(FeatureConfig(), feature_dir, device="cpu")
    g_names, g_abd, g_tnf = fe_gpu.load_features()
    if not (list(names) == list(g_names)
            and abd.astype("int64").tobytes() == g_abd.astype("int64").tobytes()
            and tnf.astype("int64").tobytes() == g_tnf.astype("int64").tobytes()):
        raise AssertionError("CPU step-1 matrices differ from the card's")
    for cpu_path, gpu_path in ((fe_cpu.abd_gz, fe_gpu.abd_gz),
                               (fe_cpu.tnf_gz, fe_gpu.tnf_gz)):
        with gzip.open(cpu_path) as a, gzip.open(gpu_path) as b:
            if a.read() != b.read():
                raise AssertionError(f"{os.path.basename(cpu_path)}: CPU "
                                     "and card CSV bytes differ")
    log(f"exact: CPU step 1 in {secs:.3f} s; {len(names)} barcodes, "
        f"abundance {abd.shape} and TNF {tnf.shape} byte-equal to the card's")


def kernel_records(n_main: int, launches: dict, at_cap: dict) -> list:
    """The JSON record of every kernel: the main path's timed at its
    scan length, cumsum (off the path) from its measurement at the cap."""
    import torch
    recs = []
    for i, (name, op, replaces) in enumerate(KERNELS):
        if KERNELS[i] in PATH_KERNELS:
            r = scan_measure(name, op, n_main, seed=200 + i)
            log_measure(name, r)
            torch.cuda.empty_cache()
        else:
            r = at_cap[name]
        recs.append({"name": name, "route": "cuda",
                     "source": "pangaea_tpu_torch/csrc/scan.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    return recs


# ---- main ----------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pangaea_tpu_torch")):
        print("chip_smoke: pangaea_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {kind}")
    log(card_line())

    phase_build()
    at_cap = phase_kernels()
    phase_repeat()
    fq, truth = sim_data()
    run = phase_pipeline(fq, truth)
    n_main = run["stats"]["sorted_windows"]
    records = kernel_records(n_main, run["launches"], at_cap)
    copies = {str(n): copy_ms(n) for n in (n_main, SCAN_CAP)}
    torch.cuda.empty_cache()
    phase_exact(fq, run["feature_dir"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"copy_ms": copies}))
    log(json.dumps({"kernels": records}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
