#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (pangaea_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each fatal on failure:

1. build    — compile the scan kernel from pangaea_tpu_torch/csrc/ (nvcc)
              and the native FASTQ reader from pangaea_tpu_torch/native/
              (g++), both at once, and print the build seconds, the card's
              name and power limit, and each scan variant's registers,
              spills, shared memory and resident blocks per SM.
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
   simulate — the FASTQs of phases 3, 6 and 8 (k31), made from their
              seeds in three spawned processes at once.
3. pipeline — the port's steps 1-3 (FASTQ -> features -> VAE latent ->
              clusters.tsv -> per-bin reads) on cuda, at the bench.py
              geometry of 800k reads (8 species x 200 kb, 10k barcodes x
              40 pairs, seed 7). Every kernel launch count is zeroed just
              before and read just after; each kernel of the path must
              have launched. ARI vs the simulator's truth must reach 0.5.
4. exact    — step 1 again with device="cpu" (the plain versions) on the
              same FASTQ: abundance and TNF matrices and the barcode
              order must be byte-equal to the card's.
5. spill    — step 1 on cuda on phase 3's FASTQ with the window cap
              lowered to 2^25 (the data is not cut): the aggregated spill
              with the device store, with the disk store, and the raw
              spill's ranged join. Each must be byte-equal to phase 3's
              in-cap matrices, say in its stats which path ran, and launch
              every scan its path runs (all three on the aggregated
              spill; cummax and cummin_reverse on the raw ranged join of
              unweighted keys).
6. paired   — the same geometry simulated as -1/-2 files with errors and
              low-quality bases (seed 7); steps 1-3 on cuda from the CLI's
              -1/-2 flags through the native reader and the quality-masked
              weighted join (ARI >= 0.5), which launches the cumsum of the
              run ids and neither fill scan (its run weight sums are an
              int64 index_add_); then step 1 again with the 2^25 cap, the
              weighted aggregated spill, byte-equal to the in-cap paired
              run. The weighted join on 82 keys whose weights sum past
              2^31 - 1 on cuda and on cpu gives the int64 count's bins.
7. assembly — step 4 on cuda (steps="4") on phase 3's directory: the
              builtin bin assembler, the k-mer vote mapper (its run-length
              scan is the CUDA cummax, which must launch), low-abundance
              recovery, reassembly, merge and circularization. Logs each
              tool's backend and fails if an external tool ran; final_asm.fa
              must hold >= 8 contigs and >= 800,000 bases (half of 8 x 200
              kb); prints contigs, bases, N50, the mapped base share, the
              low-abundance pairs per cutoff and the sub-stage seconds.
              Then KmerMapper on cuda and on cpu over the binned contigs:
              tables bit-equal, and the votes of the first 65,536 read
              pairs bit-equal; and merge_olc's builtin containment filter
              (binned contigs as seeds, the step's pool as local contigs)
              byte-equal on cuda and cpu.
8. step 1 at every k and on every histogram path, on phase 3's and
   phase 6's FASTQs:
   k21      — steps 1-3 at k = 21 on cuda (int64 keys into the same
              scans; ARI >= 0.5); step 1 at k = 21 on the CPU byte-equal
              to the card's; the three spills of phase 5 at k = 21; paired
              step 1 at k = 21 in cap, then spilled (aggregated, device
              store), byte-equal; the 82-key weight-sum case on int64
              keys.
   k31      — a small simulated file (32,000 reads, seed 8): step 1 at
              k = 31 (sentinel 2^62) on cuda and on the CPU, byte-equal.
   table    — hist_impl 'scatter' and 'segsum' at k = 15 (the 4 GiB
              dense table on the card, no scan) on both FASTQs:
              byte-equal to phase 3's and phase 6's sort-join matrices.
   jellyfish — the k = 15 table of phase 3's FASTQ counted on the card,
              exported as a jellyfish dump, imported back (equal table),
              and group_features on it gives phase 3's matrices.
9. auto-k   — step 3 without -c on cuda (steps="3") on a copy of phase
              3's 2.vae/: the BIC cluster count at pangaea_tpu's depth
              (kmax 100, 5 skeletons, 2 fits per feasible k — k below
              the skeleton's point count, 970 fits when every skeleton
              has more than 100 points — in a spawn pool), then
              RPH-KMeans at that k; prints k, the skeleton sizes, the
              seconds of the reductions on the card, of the fits (with
              the worker count) and of the final fit, and gates the ARI
              at 0.5 (no scan may launch). Then select_k_with_bic at kmax
              20 and 2 skeletons with the reducer on cuda and on cpu:
              whether the skeletons are bit-equal (else how many points
              differ), the largest relative BIC difference, and the same
              k (within 1 when the skeletons differ). Last, RPH-KMeans at
              the chosen k timed on cuda and on cpu.

Every path's launch counts are zeroed just before it and read just
after it. After the phases, cummax and cummin_reverse are timed at the
main path's scan length, cumsum at the paired path's, all three again at
the k = 21 path's, and cummax at the mapper's flat (65,536 x 244) length
on a real run-boundary array, beside torch.cummax along its rows; cumsum
is also timed at 2^28 in phase 2. Every time is the median CUDA-event time of one call. A JSON line gives copy_ms, the time of one device-to-device
copy of the same int32 bytes at each measured length (the
achievable-bandwidth yardstick beside the bound). The line before the
last is one JSON object with every kernel (name, route, source, the TPU
kernel it replaces, launches summed over the driven paths and per path,
max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms). The last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}.
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

def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from pangaea_tpu_torch import native
    from pangaea_tpu_torch.kernels import build, scan
    with ThreadPoolExecutor(2) as pool:  # one compiler per source
        scan_s = pool.submit(_timed, lambda: build.load("scan"))
        io_s = pool.submit(_timed, native.get_lib)
        scan_s, io_s = scan_s.result(), io_s.result()
    log(f"build: scan.cu in {scan_s:.3f} s into {build.BUILD_DIR}; tile "
        f"{scan.tile_elems()} elements")
    log(f"build: native/fastq_reader.cpp in {io_s:.3f} s into "
        f"{build.HOST_BUILD_DIR}")
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


def phase_kernels() -> None:
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
    for i, (name, op) in enumerate(SCAN_OPS):
        log_measure(name, scan_measure(name, op, SCAN_CAP, seed=100 + i))
        torch.cuda.empty_cache()
    # the variants no wrapper runs, at the cap too
    for op, reverse in (("max", True), ("min", False), ("sum", True)):
        check_variant(_scan_input(SCAN_CAP, op, gen, "cuda"), op, reverse,
                      "random input")
        torch.cuda.empty_cache()
    log("kernels: all six variants bit-equal at n=2^28")


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
# phase 6: the same geometry as -1/-2 files, with errors and low-quality
# bases so the quality mask matters
PAIRED_SIM = dict(SIM, error_rate=0.005, low_qual_rate=0.02)
# phase 8's k = 31 file: small, with errors and low-quality bases
K31_SIM = dict(n_species=2, genome_len=60_000, n_barcodes=400,
               pairs_per_barcode=40, read_len=150, error_rate=0.005,
               low_qual_rate=0.02, seed=8)
N_CLUSTERS = 8
ARI_GATE = 0.5
SPILL_CAP = 1 << 25   # phase 5-6 window cap (phase 3's stream is ~2^26.7)
# every kernel: (wrapper, op, TPU kernel replaced)
KERNELS = (
    ("cummax", "max",
     "pangaea_tpu/kernels/scan.py:72 (_scan_kernel via cummax :153)"),
    ("cummin_reverse", "min",
     "pangaea_tpu/kernels/scan.py:72 (_scan_kernel via cummin_reverse "
     ":157)"),
    ("cumsum", "sum",
     "pangaea_tpu/kernels/scan.py:72 (_scan_kernel via cumsum :161)"),
)
ALL_SCANS = ("cummax", "cummin_reverse", "cumsum")
FILL_SCANS = ("cummax", "cummin_reverse")
# the weighted join: the run ids' cumsum; the fills must not launch
WEIGHTED_SCANS = ("cumsum",)


def smoke_dir() -> str:
    d = os.path.join(HERE, "build", "smoke")
    os.makedirs(d, exist_ok=True)
    return d


def sim_data(name: str, sim: dict, paired: bool) -> tuple:
    """Simulated FASTQ(s) made from the seed in ``sim``: one interleaved
    file, or R1/R2 files; reused when build/smoke/<name> already holds
    them for the same arguments. Returns (paths, barcode -> species)."""
    from pangaea_tpu_torch.io.sim import simulate_linked_reads
    d = os.path.join(smoke_dir(), name)
    os.makedirs(d, exist_ok=True)
    files = ("r1.fq.gz", "r2.fq.gz") if paired else ("reads.fq.gz",)
    paths = [os.path.join(d, f) for f in files]
    meta = os.path.join(d, "truth.json")
    if os.path.exists(meta):
        with open(meta) as f:
            saved = json.load(f)
        if saved["sim"] == sim and all(map(os.path.exists, paths)):
            log(f"{name}: reusing {paths}")
            return paths, saved["barcode_species"]
    t0 = time.perf_counter()
    tmps = [p + ".tmp.gz" for p in paths]
    if paired:
        res = simulate_linked_reads(out_r1=tmps[0], out_r2=tmps[1], **sim)
    else:
        res = simulate_linked_reads(out_interleaved=tmps[0], **sim)
    for tmp, path in zip(tmps, paths):
        os.replace(tmp, path)
    with open(meta, "w") as f:
        json.dump({"sim": sim, "barcode_species": res.barcode_species}, f)
    log(f"{name}: simulated {2 * res.n_pairs} reads in "
        f"{time.perf_counter() - t0:.1f} s")
    return paths, res.barcode_species


def simulate_all(specs: list) -> list:
    """sim_data of every (name, sim, paired) in ``specs`` at once, one
    spawned process each: the simulator is single-threaded host Python
    and gzip, and nothing else runs meanwhile."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(specs), mp_context=ctx) as pool:
        futures = [pool.submit(sim_data, *spec) for spec in specs]
        return [f.result() for f in futures]


def read_clusters(tsv: str) -> dict:
    out = {}
    with open(tsv) as f:
        for line in f:
            cid, bcs = line.rstrip("\n").split("\t")
            for bc in bcs.split(","):
                out[bc] = int(cid)
    return out


def launch_counts() -> dict:
    from pangaea_tpu_torch.kernels import scan
    return {fn.__name__: fn.launches for fn in scan.WRAPPERS}


def check_launched(what: str, launches: dict, names, absent=()) -> None:
    """Every kernel in ``names`` launched, and none in ``absent``."""
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{what} never launched {name}: "
                                 f"{launches}")
    for name in absent:
        if launches[name] != 0:
            raise AssertionError(f"{what} launched {name}, which its path "
                                 f"does not run: {launches}")


def log_stats(what: str, stats: dict) -> None:
    if stats["path"] == "table":
        log(f"{what}: step-1 table path: global pass {stats['global_s']:.3f}"
            f" s, group pass {stats['group_s']:.3f} s")
        return
    log(f"{what}: step-1 io {stats['io']}, spill {stats['spill']}, store "
        f"{stats['store']}; stream {stats['stream_s']:.3f} s, sort-join "
        f"{stats['sortjoin_s']:.3f} s, replay {stats['replay_s']:.3f} s; "
        f"{stats['windows']} windows, {stats['sorted_windows']} sorted, "
        f"{stats['batches']} batches, {stats['chunks']} chunks, "
        f"{stats['spill_chunks']} aggregation chunks, {stats['ranges']} "
        f"key ranges")


def run_pipeline(what: str, cfg, truth: dict, kernels, absent=()) -> dict:
    """Steps 1-3 of ``cfg`` on cuda with the launch counts zeroed just
    before; checks the markers, the kernels launched, the latent, the
    bin FASTQs and the ARI vs truth."""
    import numpy as np
    import torch
    from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished
    out = cfg.output
    shutil.rmtree(out, ignore_errors=True)
    pipe = Pipeline(cfg, device="cuda")
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for step in ("1", "2", "3"):
        if not check_step_finished(out, step):
            raise AssertionError(f"{what}: step {step} left no marker")
    check_launched(what, launches, kernels, absent)
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
    log(f"{what}: steps 1-3 on cuda in {wall:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()))
    log_stats(what, stats)
    log(f"{what}: scan launches {launches}; {len(clusters)} barcodes "
        f"clustered, latent {latent.shape}, {len(bins)} bin FASTQs; "
        f"ARI vs truth {ari:.6f} on {len(labelled)} labelled barcodes")
    if not (latent.ndim == 2 and latent.shape[1] == cfg.model.latent_dim
            and np.isfinite(latent).all()):
        raise AssertionError(f"{what}: bad latent {latent.shape}")
    if len(bins) != len(set(clusters.values())):
        raise AssertionError(f"{what}: {len(bins)} bin FASTQs for "
                             f"{len(set(clusters.values()))} clusters")
    if ari < ARI_GATE:
        raise AssertionError(f"{what}: ARI {ari} below {ARI_GATE}")
    return {"out": out, "wall_s": wall, "steps": steps, "stats": stats,
            "launches": launches, "ari": ari, "n_barcodes": len(clusters),
            "feature_dir": pipe.feature_dir}


def phase_pipeline(fq: str, truth: dict) -> dict:
    from pangaea_tpu_torch.config import ClusterConfig, PangaeaConfig
    cfg = PangaeaConfig(interleaved_reads=fq,
                        output=os.path.join(smoke_dir(), "run"),
                        steps="1,2,3",
                        cluster=ClusterConfig(n_clusters=N_CLUSTERS))
    return run_pipeline("pipeline", cfg, truth, FILL_SCANS)


# ---- phase 4 -------------------------------------------------------------

def same_features(a: tuple, b: tuple) -> bool:
    """Barcode order and both matrices byte-equal."""
    return (list(a[0]) == list(b[0])
            and all(x.astype("int64").tobytes() == y.astype("int64").tobytes()
                    for x, y in zip(a[1:], b[1:])))


def load_features(feature_dir: str, **feature) -> tuple:
    from pangaea_tpu_torch.config import FeatureConfig
    from pangaea_tpu_torch.features import FeatureExtractor
    return FeatureExtractor(FeatureConfig(**feature), feature_dir,
                            device="cpu").load_features()


def phase_exact(fq: str, feature_dir: str, what: str = "exact",
                **feature) -> None:
    """Step 1 with the plain versions on the CPU must reproduce the
    card's feature files in ``feature_dir`` byte for byte."""
    import gzip
    from pangaea_tpu_torch.config import FeatureConfig
    from pangaea_tpu_torch.features import FeatureExtractor
    cpu_dir = os.path.join(smoke_dir(), f"cpu_features_{what}")
    shutil.rmtree(cpu_dir, ignore_errors=True)
    t0 = time.perf_counter()
    fe_cpu = FeatureExtractor(FeatureConfig(**feature), cpu_dir,
                              device="cpu")
    names, abd, tnf = fe_cpu.extract_features(interleaved=fq)
    secs = time.perf_counter() - t0
    fe_gpu = FeatureExtractor(FeatureConfig(**feature), feature_dir,
                              device="cpu")
    if not same_features((names, abd, tnf), fe_gpu.load_features()):
        raise AssertionError(f"{what}: CPU step-1 matrices differ from the "
                             "card's")
    for cpu_path, gpu_path in ((fe_cpu.abd_gz, fe_gpu.abd_gz),
                               (fe_cpu.tnf_gz, fe_gpu.tnf_gz)):
        with gzip.open(cpu_path) as a, gzip.open(gpu_path) as b:
            if a.read() != b.read():
                raise AssertionError(f"{what}: {os.path.basename(cpu_path)}"
                                     ": CPU and card CSV bytes differ")
    log(f"{what}: CPU step 1 in {secs:.3f} s; {len(names)} barcodes, "
        f"abundance {abd.shape} and TNF {tnf.shape} byte-equal to the card's")


# ---- phases 5-6 ------------------------------------------------------------

def run_step1(what: str, inputs: dict, expect, kernels, spill: str,
              store: str, absent=(), **feature) -> dict:
    """Step 1 alone on cuda with the launch counts zeroed just before;
    its matrices must equal ``expect`` (unless None) and its stats must
    name the path that ran: (spill, store) of the sort-join, or spill
    "table" for the dense-table path, which launches no scan."""
    import torch
    from pangaea_tpu_torch.config import FeatureConfig
    from pangaea_tpu_torch.features import FeatureExtractor
    from pangaea_tpu_torch.kernels import scan
    d = os.path.join(smoke_dir(), what)
    shutil.rmtree(d, ignore_errors=True)
    fe = FeatureExtractor(FeatureConfig(**feature), d, device="cuda")
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fe.extract_features(**inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    stats = fe.stats
    log(f"{what}: step 1 on cuda in {secs:.3f} s; scan launches {launches}")
    log_stats(what, stats)
    ran = (("table", None) if stats["path"] == "table"
           else (stats["spill"], stats["store"]))
    if ran != (spill, store):
        raise AssertionError(f"{what}: ran {ran}, expected {(spill, store)}")
    check_launched(what, launches, kernels, absent)
    if spill == "table" and any(launches.values()):
        raise AssertionError(f"{what}: the table path launched {launches}")
    if expect is not None:
        if not same_features(got, expect):
            raise AssertionError(f"{what}: matrices differ from the "
                                 "expected run's")
        log(f"{what}: {len(got[0])} barcodes byte-equal to the expected run")
    return {"launches": launches, "stats": dict(stats), "seconds": secs,
            "features": got}


def phase_spill(fq: str, feature_dir: str) -> dict:
    expect = load_features(feature_dir)
    inputs = {"interleaved": fq}
    spill_dir = os.path.join(smoke_dir(), "spill_store")
    shutil.rmtree(spill_dir, ignore_errors=True)
    runs = {
        "spill-agg-device": run_step1(
            "spill-agg-device", inputs, expect, ALL_SCANS, "agg", "device",
            sortjoin_max_windows=SPILL_CAP),
        "spill-agg-disk": run_step1(
            "spill-agg-disk", inputs, expect, ALL_SCANS, "agg", "disk",
            sortjoin_max_windows=SPILL_CAP, spill_store="disk",
            spill_dir=spill_dir),
        "spill-raw": run_step1(
            "spill-raw", inputs, expect, FILL_SCANS, "raw", "host",
            sortjoin_max_windows=SPILL_CAP, spill_agg="off"),
    }
    if os.listdir(spill_dir):
        raise AssertionError(f"disk spill left {os.listdir(spill_dir)}")
    return runs


def phase_paired(r1: str, r2: str, truth: dict) -> dict:
    from pangaea_tpu_torch.pipeline import cli
    parser = cli.build_parser()
    args = parser.parse_args(["-1", r1, "-2", r2, "-o",
                              os.path.join(smoke_dir(), "paired_run"),
                              "-c", str(N_CLUSTERS), "-st", "1,2,3"])
    cli.check_supported(parser, args)
    run = run_pipeline("paired", cli.config_from_args(args), truth,
                       WEIGHTED_SCANS, FILL_SCANS)
    if run["stats"]["io"] != "native" or run["stats"]["spill"] != "none":
        raise AssertionError(f"paired: step 1 ran {run['stats']}")
    run["spill"] = run_step1(
        "paired-spill-agg", {"reads1": r1, "reads2": r2},
        load_features(run["feature_dir"]), WEIGHTED_SCANS, "agg", "device",
        FILL_SCANS, sortjoin_max_windows=SPILL_CAP)
    check_wrap("paired", 15)
    return run


def check_wrap(what: str, k: int) -> None:
    """The weighted join on 82 keys weighted 50, 80 x 30,000,000 and 50
    (2,400,000,100 in all, past 2^31 - 1) on cuda and on cpu: both give
    the int64 numpy count's bins, 5 for the two keys of count 50."""
    import numpy as np
    import torch
    from pangaea_tpu_torch.kernels.features import sortjoin_bins_weighted
    dt = np.int64 if k > 15 else np.int32
    keys = (np.arange(82) * 7919).astype(dt)
    w = np.array([50] + [30_000_000] * 80 + [50], np.int32)
    counts = w.astype(np.int64)   # every key once: its count is its weight
    want = np.where(counts // 10 < 400, counts // 10, -1)
    got = {}
    for dev in ("cuda", "cpu"):
        got[dev] = sortjoin_bins_weighted(
            torch.from_numpy(keys).to(dev), torch.from_numpy(w).to(dev),
            k=k, window=10, vector_size=400).cpu().numpy()
        if got[dev].dtype != np.int32 or not np.array_equal(got[dev], want):
            raise AssertionError(f"{what}: weighted join past 2^31 - 1 on "
                                 f"{dev} gave {got[dev][[0, 1, -1]]}, the "
                                 f"int64 count {want[[0, 1, -1]]}")
    log(f"{what}: weighted join of 82 keys weighing {int(counts.sum())} in "
        f"all at k = {k}: bins {got['cuda'][[0, -1]].tolist()} on cuda = "
        f"cpu = the int64 count's")


# ---- phase 7 -------------------------------------------------------------

# half of 8 x 200 kb: the ratio of pangaea_tpu's tests/test_pipeline.py gate
ASM_MIN_CONTIGS, ASM_MIN_BASES = 8, 800_000
MAP_PAIRS = 65_536        # read pairs mapped on the card and on the CPU
MAP_BATCH_PAIRS = 32_768  # map_pairs_to_bam's batch: 65,536 rows per call


def n50(lengths) -> int:
    acc, half = 0, sum(lengths) / 2
    for n in sorted(lengths, reverse=True):
        acc += n
        if acc >= half:
            return n
    return 0


def check_builtin(what: str, backend: dict) -> None:
    """Log each tool's backend; the card's machine has none of the
    external tools, so anything but the builtin (or a skip) is a fault."""
    log(f"{what}: backends {json.dumps(backend, sort_keys=True)}")
    external = {k: v for k, v in backend.items()
                if not v.startswith(("builtin", "skipped"))}
    if external:
        raise AssertionError(f"{what}: external tools ran where the builtin "
                             f"was expected: {external}")


def mapper_pairs(fq: str, n: int) -> list:
    import itertools
    from pangaea_tpu_torch.io.grouping import iter_read_pairs_interleaved
    return [(p.seq1, p.seq2) for p in
            itertools.islice(iter_read_pairs_interleaved(fq), n)]


def check_mapper_devices(contigs_fa: str, fq: str) -> dict:
    """KmerMapper on cuda and on cpu over the binned contigs: the index
    tables bit-equal, then (best, votes, nvalid) of the first MAP_PAIRS
    read pairs, mapped in the path's batches, bit-equal. Returns the
    first batch's run-boundary array (the cummax input) on the card."""
    import numpy as np
    import torch
    from pangaea_tpu_torch.asm.fasta import iter_fasta
    from pangaea_tpu_torch.asm.mapper import (KmerMapper, run_boundaries,
                                              sorted_row_ids)
    contigs = list(iter_fasta(contigs_fa))
    maps = {}
    for dev in ("cuda", "cpu"):
        m = KmerMapper(device=dev)
        m.index_contigs(contigs)
        maps[dev] = m
    if not torch.equal(maps["cuda"].table.cpu(), maps["cpu"].table):
        raise AssertionError("assembly: the card's k-mer table differs from "
                             "the CPU's")
    pairs = mapper_pairs(fq, MAP_PAIRS)
    boundary = None
    for lo in range(0, len(pairs), MAP_BATCH_PAIRS):
        seqs = [s for p in pairs[lo:lo + MAP_BATCH_PAIRS] for s in p]
        got = maps["cuda"].map_reads(seqs)
        want = maps["cpu"].map_reads(seqs)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"assembly: the card's votes differ from "
                                 f"the CPU's in pairs {lo}..")
        if boundary is None:
            m = maps["cuda"]
            s, _ = sorted_row_ids(m.table, *m.encode_reads(seqs), k=m.k)
            boundary = run_boundaries(s)[1]
    log(f"assembly: KmerMapper table ({4 ** maps['cpu'].k} entries, "
        f"{len(contigs)} contigs) and the votes of {len(pairs)} read pairs "
        f"bit-equal on cuda and cpu")
    del maps
    torch.cuda.empty_cache()
    return boundary


def check_containment_devices(contigs_fa: str, pool_fa: str) -> None:
    """merge_olc's builtin containment filter (1,024-wide mapper rows),
    binned contigs as seeds and the step's pool as local contigs, on cuda
    and on cpu: byte-equal outputs."""
    from pangaea_tpu_torch.asm.merge_olc import merge_olc
    outs, t = {}, {}
    for dev in ("cuda", "cpu"):
        d = os.path.join(smoke_dir(), f"containment_{dev}")
        shutil.rmtree(d, ignore_errors=True)
        stats = {}
        t0 = time.perf_counter()
        final = merge_olc(contigs_fa, pool_fa, d, device=dev, stats=stats)
        t[dev] = time.perf_counter() - t0
        check_builtin(f"containment ({dev})", stats["backend"])
        with open(final, "rb") as f, open(os.path.join(
                d, "pre-flye-input-contigs.filt.fa"), "rb") as g:
            outs[dev] = (f.read(), g.read())
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("assembly: merge_olc's containment filter "
                             "differs between cuda and cpu")
    kept = outs["cuda"][1].count(b">")
    with open(pool_fa, "rb") as f:
        pooled = f.read().count(b">")
    log(f"assembly: merge_olc builtin containment byte-equal on cuda and "
        f"cpu ({t['cuda']:.3f} / {t['cpu']:.3f} s): {kept} of {pooled} "
        f"pooled contigs kept")


def phase_assembly(run: dict, fq: str, truth: dict) -> dict:
    """Step 4 on cuda on phase 3's directory, then the mapper and the
    containment filter held against the CPU."""
    import torch
    from collections import Counter
    from pangaea_tpu_torch.asm.fasta import iter_fasta
    from pangaea_tpu_torch.config import ClusterConfig, PangaeaConfig
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished
    out = run["out"]
    cfg = PangaeaConfig(interleaved_reads=fq, output=out, steps="4",
                        cluster=ClusterConfig(n_clusters=N_CLUSTERS))
    species = Counter(truth.values())
    reads_per_bc = 2 * SIM["pairs_per_barcode"]
    log("assembly: simulated reads per species "
        + json.dumps({s: n * reads_per_bc for s, n in sorted(species.items())}))
    pipe = Pipeline(cfg, device="cuda")
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    stats = pipe.assembly_stats
    check_builtin("assembly", stats["backend"])
    if not check_step_finished(out, "4"):
        raise AssertionError("assembly: step 4 left no marker")
    check_launched("assembly", launches, ("cummax",))
    lengths = [len(s) for _, s in iter_fasta(os.path.join(out,
                                                          "final_asm.fa"))]
    share = stats["mapped_bases"] / max(stats["read_bases"], 1)
    secs = {k: round(v, 3) for k, v in stats.items() if k.endswith("_s")}
    log(f"assembly: step 4 on cuda in {wall:.3f} s; sub-stages {secs}")
    log(f"assembly: final_asm.fa {len(lengths)} contigs, {sum(lengths)} "
        f"bases, N50 {n50(lengths)}; {stats['read_pairs']} read pairs "
        f"mapped back, mapped base share {share:.6f}; low-abundance pairs "
        f"per cutoff {stats['low_abd_pairs']}; scan launches {launches}")
    if len(lengths) < ASM_MIN_CONTIGS or sum(lengths) < ASM_MIN_BASES:
        raise AssertionError(f"assembly: {len(lengths)} contigs, "
                             f"{sum(lengths)} bases; the gate is "
                             f"{ASM_MIN_CONTIGS} and {ASM_MIN_BASES}")
    contigs_fa = os.path.join(out, "3.clustering", "contigs.megahit.fa")
    boundary = check_mapper_devices(contigs_fa, fq)
    check_containment_devices(contigs_fa, os.path.join(
        out, "4.assembly", "contigs.low_abd.binning.local.fa"))
    return {"wall_s": wall, "launches": launches, "stats": stats,
            "boundary": boundary}


# ---- phase 8 -------------------------------------------------------------

LARGE_K = 21


def phase_k21(fq: str, truth: dict, r1: str, r2: str) -> dict:
    """k = 21 on int64 keys: steps 1-3 on cuda, step 1 on the CPU, the
    three spills, and paired step 1 in cap and spilled."""
    from pangaea_tpu_torch.config import (ClusterConfig, FeatureConfig,
                                          PangaeaConfig)
    k = {"kmer": LARGE_K}
    cfg = PangaeaConfig(interleaved_reads=fq,
                        output=os.path.join(smoke_dir(), "k21_run"),
                        steps="1,2,3", feature=FeatureConfig(**k),
                        cluster=ClusterConfig(n_clusters=N_CLUSTERS))
    run = run_pipeline("k21", cfg, truth, FILL_SCANS)
    if run["stats"]["spill"] != "none":
        raise AssertionError(f"k21: step 1 ran {run['stats']}")
    phase_exact(fq, run["feature_dir"], "k21-exact", **k)
    expect = load_features(run["feature_dir"], **k)
    inputs = {"interleaved": fq}
    spill_dir = os.path.join(smoke_dir(), "spill_store_k21")
    shutil.rmtree(spill_dir, ignore_errors=True)
    paths = {
        "k21-spill-agg-device": run_step1(
            "k21-spill-agg-device", inputs, expect, ALL_SCANS, "agg",
            "device", sortjoin_max_windows=SPILL_CAP, **k),
        "k21-spill-agg-disk": run_step1(
            "k21-spill-agg-disk", inputs, expect, ALL_SCANS, "agg", "disk",
            sortjoin_max_windows=SPILL_CAP, spill_store="disk",
            spill_dir=spill_dir, **k),
        "k21-spill-raw": run_step1(
            "k21-spill-raw", inputs, expect, FILL_SCANS, "raw", "host",
            sortjoin_max_windows=SPILL_CAP, spill_agg="off", **k),
    }
    if os.listdir(spill_dir):
        raise AssertionError(f"k21 disk spill left {os.listdir(spill_dir)}")
    paired = {"reads1": r1, "reads2": r2}
    paths["k21-paired"] = run_step1("k21-paired", paired, None,
                                    WEIGHTED_SCANS, "none", "device",
                                    FILL_SCANS, **k)
    paths["k21-paired-spill-agg"] = run_step1(
        "k21-paired-spill-agg", paired, paths["k21-paired"]["features"],
        WEIGHTED_SCANS, "agg", "device", FILL_SCANS,
        sortjoin_max_windows=SPILL_CAP, **k)
    check_wrap("k21", LARGE_K)
    return {"run": run, "paths": paths}


def phase_k31(fq: str) -> dict:
    """k = 31 (the largest key, sentinel 2^62) on a small file: step 1 on
    cuda, then on the CPU, byte-equal."""
    run = run_step1("k31", {"interleaved": fq}, None, FILL_SCANS, "none",
                    "device", kmer=31)
    phase_exact(fq, os.path.join(smoke_dir(), "k31"), "k31-exact", kmer=31)
    return run


def phase_table(fq: str, feature_dir: str, r1: str, r2: str,
                paired_dir: str) -> dict:
    """The dense-table paths at k = 15 on both FASTQs: byte-equal to the
    sort-join's matrices of phases 3 and 6, no scan launched."""
    runs = {}
    for impl in ("scatter", "segsum"):
        runs[f"table-{impl}"] = run_step1(
            f"table-{impl}", {"interleaved": fq}, load_features(feature_dir),
            (), "table", None, hist_impl=impl)
        runs[f"table-{impl}-paired"] = run_step1(
            f"table-{impl}-paired", {"reads1": r1, "reads2": r2},
            load_features(paired_dir), (), "table", None, hist_impl=impl)
    return runs


def phase_jellyfish(fq: str, feature_dir: str) -> dict:
    """Phase 3's k = 15 table counted on the card, exported as a
    jellyfish dump, imported back: the same table, and group_features on
    it gives phase 3's matrices."""
    import torch
    from pangaea_tpu_torch.config import FeatureConfig
    from pangaea_tpu_torch.features import FeatureExtractor
    d = os.path.join(smoke_dir(), "jellyfish")
    shutil.rmtree(d, ignore_errors=True)
    fe = FeatureExtractor(FeatureConfig(hist_impl="scatter"), d,
                          device="cuda")
    t = {}
    t0 = time.perf_counter()
    table = fe.global_kmer_table(interleaved=fq)
    torch.cuda.synchronize()
    t["count_s"] = time.perf_counter() - t0
    dump = os.path.join(d, "mer_counts.dump.tsv")
    t0 = time.perf_counter()
    n = fe.export_jellyfish_dump(table, dump)
    t["export_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = fe.import_jellyfish_dump(dump)
    torch.cuda.synchronize()
    t["import_s"] = time.perf_counter() - t0
    if back.device.type != "cuda" or not torch.equal(back, table):
        raise AssertionError("jellyfish: the imported table differs from "
                             "the exported one")
    del table
    t0 = time.perf_counter()
    got = fe.group_features(back, interleaved=fq)
    torch.cuda.synchronize()
    t["group_s"] = time.perf_counter() - t0
    del back
    torch.cuda.empty_cache()
    if not same_features(got, load_features(feature_dir)):
        raise AssertionError("jellyfish: group_features on the imported "
                             "dump differs from phase 3's matrices")
    log(f"jellyfish: {n} k-mers ({os.path.getsize(dump)} bytes) exported "
        f"and imported; group_features on the imported table gives phase "
        f"3's {len(got[0])} barcodes; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in t.items()))
    return t


# ---- phase 9 -------------------------------------------------------------

def compare_skeletons(cuda: list, cpu: list) -> tuple:
    """(bit-equal, description) of two lists of (points, weights)
    skeletons."""
    import numpy as np
    equal, notes = True, []
    for s, ((pc, wc), (pp, wp)) in enumerate(zip(cuda, cpu)):
        if pc.shape != pp.shape:
            equal = False
            notes.append(f"skeleton {s}: {len(pc)} points on cuda, "
                         f"{len(pp)} on cpu")
            continue
        rows = int((~((pc == pp).all(1) & (wc == wp))).sum())
        equal &= rows == 0
        notes.append(f"skeleton {s}: {len(pc)} points, {rows} differ")
    return equal, "; ".join(notes)


def phase_autok(run: dict, fq: str, truth: dict) -> dict:
    """Step 3 without -c on cuda on a copy of phase 3's 2.vae/, then the
    BIC count at a smaller depth with the reducer on cuda and on cpu, then
    RPH-KMeans at the chosen k on cuda and on cpu (times only)."""
    import numpy as np
    import torch
    from pangaea_tpu_torch.cluster import (clustering_rph_kmeans,
                                           select_k_with_bic)
    from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
    from pangaea_tpu_torch.config import PangaeaConfig
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished
    from pangaea_tpu_torch.utils import cpu_count
    out = os.path.join(smoke_dir(), "autok_run")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(run["out"], "2.vae"),
                    os.path.join(out, "2.vae"))
    cfg = PangaeaConfig(interleaved_reads=fq, output=out, steps="3")
    pipe = Pipeline(cfg, device="cuda")
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check_launched("auto-k", launches, (), ALL_SCANS)
    if not check_step_finished(out, "3"):
        raise AssertionError("auto-k: step 3 left no marker")
    st = pipe.cluster_stats
    clusters = read_clusters(os.path.join(out, "3.clustering",
                                          "clusters.tsv"))
    labelled = [bc for bc in clusters if bc in truth]
    ari = adjusted_rand_score([truth[bc] for bc in labelled],
                              [clusters[bc] for bc in labelled])
    k = st["k"]
    sizes = [len(p) for p, _ in st["skeletons"]]
    log(f"auto-k: step 3 without -c on cuda in {wall:.3f} s; k = {k} by "
        f"{st['k_source']} ({len(set(clusters.values()))} clusters); "
        f"{len(sizes)} reductions on the card {st['reduce_s']:.3f} s to "
        f"skeletons of {sizes} points, {st['n_fits']} skeleton fits in "
        f"{st['workers']} workers {st['fits_s']:.3f} s (os.cpu_count() "
        f"{os.cpu_count()}), final RPH-KMeans {st['rph_s']:.3f} s; scan "
        f"launches {launches}; ARI vs truth {ari:.6f} on {len(labelled)} "
        f"labelled barcodes")
    # two fits for every k in 4..100 below the skeleton's point count
    n_fits = sum(2 * max(0, min(100, n - 1) - 3) for n in sizes)
    if st["k_source"] != "bic" or st["n_fits"] != n_fits:
        raise AssertionError(f"auto-k: expected {n_fits} BIC fits, got "
                             f"{st['n_fits']} ({st['k_source']})")
    if ari < ARI_GATE:
        raise AssertionError(f"auto-k: ARI {ari} below {ARI_GATE} at k {k}")
    latent = np.load(os.path.join(out, "2.vae", "latent.npz"))["arr_0"]
    small = {}
    for dev in ("cuda", "cpu"):
        sst = {}
        t0 = time.perf_counter()
        sk, lists, _ = select_k_with_bic(
            latent, kmax=20, kmin=4, ske_repeat=2, k_repeat=2,
            random_state=0, device=dev, workers=cpu_count(), stats=sst)
        small[dev] = (sk, np.asarray(lists), sst, time.perf_counter() - t0)
    equal, notes = compare_skeletons(small["cuda"][2]["skeletons"],
                                     small["cpu"][2]["skeletons"])
    bc, bp = small["cuda"][1], small["cpu"][1]
    if not np.array_equal(np.isinf(bc), np.isinf(bp)):
        raise AssertionError("auto-k: -inf BIC entries differ cuda vs cpu")
    fin = np.isfinite(bp)
    rel = float(np.max(np.abs(bc[fin] - bp[fin]) / np.abs(bp[fin]),
                       initial=0.0))
    kc, kp = small["cuda"][0], small["cpu"][0]
    tc, tp = small["cuda"][3], small["cpu"][3]
    log(f"auto-k: kmax 20, 2 skeletons: k {kc} (reducer on cuda, {tc:.3f} "
        f"s) vs {kp} (cpu, {tp:.3f} s); skeletons bit-equal: {equal} "
        f"({notes}); largest relative BIC difference {rel:.3e}")
    if (equal and kc != kp) or abs(kc - kp) > 1:
        raise AssertionError(f"auto-k: k {kc} on cuda, {kp} on cpu "
                             f"(skeletons bit-equal: {equal})")
    rph = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        labels = clustering_rph_kmeans(latent, k, n_init=cfg.cluster.n_init,
                                       random_state=cfg.model.seed,
                                       device=dev)
        rph[dev] = (time.perf_counter() - t0, labels)
    agree = adjusted_rand_score(rph["cuda"][1], rph["cpu"][1])
    log(f"auto-k: RPH-KMeans at k = {k} on the {latent.shape} latent: cuda "
        f"{rph['cuda'][0]:.3f} s, cpu {rph['cpu'][0]:.3f} s; ARI cuda vs "
        f"cpu labels {agree:.6f}")
    return {"launches": launches, "k": k, "ari": ari}


def mapper_cummax_record(boundary, launches: int) -> dict:
    """cummax at the mapper's flat length: kernel vs plain version on the
    run-boundary array of a real map batch, beside torch.cummax along the
    rows of its (R, W) view (which computes the same function there:
    every row opens with its own global index)."""
    import torch
    from pangaea_tpu_torch.kernels import scan
    R, W = boundary.shape
    x = boundary.reshape(-1).contiguous()
    got = scan.cummax(x)
    want = scan.cummax_plain(x)
    lib = torch.cummax(boundary, dim=1).values.reshape(-1)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(lib, want):
        raise AssertionError(f"cummax at the mapper's ({R}, {W}): kernel "
                             f"or torch.cummax(dim=1) != plain (err {err})")
    del got, want, lib
    r = {"n": R * W, "max_abs_err": err,
         "ms": time_ms(lambda: scan.cummax(x)),
         "plain_ms": time_ms(lambda: scan.cummax_plain(x)),
         "library_ms": time_ms(lambda: torch.cummax(boundary, dim=1))}
    r["bound_ms"], r["bound_by"] = scan_bound_ms(R * W)
    log_measure(f"cummax (mapper rows {R} x {W})", r)
    return {"name": "cummax", "route": "cuda",
            "source": "pangaea_tpu_torch/csrc/scan.cu",
            "replaces": KERNELS[0][2], "launches": launches,
            "launches_by_path": {"assembly": launches}, **r}


def kernel_records(lengths: dict, by_path: dict) -> list:
    """The JSON record of every kernel, timed at ``lengths[name]``;
    launches summed over the driven paths, and per path."""
    import torch
    recs = []
    for i, (name, op, replaces) in enumerate(KERNELS):
        r = scan_measure(name, op, lengths[name], seed=200 + i)
        log_measure(name, r)
        torch.cuda.empty_cache()
        per_path = {p: l[name] for p, l in by_path.items()}
        recs.append({"name": name, "route": "cuda",
                     "source": "pangaea_tpu_torch/csrc/scan.cu",
                     "replaces": replaces,
                     "launches": sum(per_path.values()),
                     "launches_by_path": per_path,
                     "n": lengths[name],
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
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {kind}")
    log(card_line())

    phase("build", phase_build)
    phase("kernels", phase_kernels)
    phase("repeat", phase_repeat)
    ((fq,), truth), ((r1, r2), ptruth), ((fq31,), _) = phase(
        "simulate", simulate_all, [("data", SIM, False),
                                   ("data_paired", PAIRED_SIM, True),
                                   ("data_k31", K31_SIM, False)])
    run = phase("pipeline", phase_pipeline, fq, truth)
    phase("exact", phase_exact, fq, run["feature_dir"])
    spills = phase("spill", phase_spill, fq, run["feature_dir"])
    paired = phase("paired", phase_paired, r1, r2, ptruth)
    asm = phase("assembly", phase_assembly, run, fq, truth)
    k21 = phase("k21", phase_k21, fq, truth, r1, r2)
    k31 = phase("k31", phase_k31, fq31)
    tables = phase("table", phase_table, fq, run["feature_dir"], r1, r2,
                   paired["feature_dir"])
    phase("jellyfish", phase_jellyfish, fq, run["feature_dir"])
    autok = phase("auto-k", phase_autok, run, fq, truth)
    k21_paths = {"k21": k21["run"]["launches"],
                 **{k: v["launches"] for k, v in k21["paths"].items()},
                 "k31": k31["launches"]}
    by_path = {"pipeline": run["launches"],
               **{k: v["launches"] for k, v in spills.items()},
               "paired": paired["launches"],
               "paired-spill-agg": paired["spill"]["launches"],
               "assembly": asm["launches"], **k21_paths,
               **{k: v["launches"] for k, v in tables.items()},
               "auto-k": autok["launches"]}
    n_main = run["stats"]["sorted_windows"]
    n_paired = paired["stats"]["sorted_windows"]
    n_k21 = k21["run"]["stats"]["sorted_windows"]
    n_map = asm["boundary"].numel()
    records = phase("timing", kernel_records,
                    {"cummax": n_main, "cummin_reverse": n_main,
                     "cumsum": n_paired}, by_path)
    # the scans again at the k = 21 sort length, with the large-k paths'
    # launches
    records += kernel_records({name: n_k21 for name in ALL_SCANS},
                              k21_paths)
    records.append(mapper_cummax_record(asm.pop("boundary"),
                                        asm["launches"]["cummax"]))
    copies = {str(n): copy_ms(n) for n in sorted({n_main, n_paired, n_k21,
                                                  n_map, SCAN_CAP})}
    torch.cuda.empty_cache()
    log(f"total {time.perf_counter() - t_start:.1f} s; phases "
        + json.dumps({k: round(v, 3) for k, v in phase_s.items()}))
    log(json.dumps({"copy_ms": copies}))
    log(json.dumps({"kernels": records}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
