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
   simulate — the FASTQs of phases 3, 6, 8 (k31) and 10 (raw stLFR),
              made from their seeds in four spawned processes at once.
3. pipeline — the port's steps 1-3 (FASTQ -> features -> VAE latent ->
              clusters.tsv -> per-bin reads) on cuda, at the bench.py
              geometry of 800k reads (8 species x 200 kb, 10k barcodes x
              40 pairs, seed 7); step 2 on the fused loop (pangaea_tpu's
              default), whose evals, last epoch and phase_times are
              printed. Every kernel launch count is zeroed just
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
10. driver  — driver.main on cuda from raw reads (--skip-external):
              -s 10x on phase 6's pairs, steps 1-3: the sorted FASTQ holds
              the input's records (as a multiset), its tags sorted and
              the unbarcoded last, GNU sort's bytes equal the native
              sort's, ARI >= 0.5; -s stlfr -w on a raw stLFR simulation
              (8 species x 200 kb, 10,000 partitions x 40 pairs, 1,536
              whitelist barcodes, seed 7), steps 1-3, ARI >= 0.5 against
              its translated barcodes; -s tellseq -I, step 0 only, on
              R1/R2/I1 written from phase 3's first 100,000 pairs with
              18-bp barcodes (every 1000th 17 bp, dropped): the record
              count and every BX tag; hybrid -s short -l, step 0 only,
              long reads cut to 10 kb from phase 7's final_asm.fa and
              phase 6's first 100,000 pairs: the builtin mapper on cuda
              (its cummax must launch; no bwa there), >= 90 % of the
              pairs barcoded, tags sorted. Prints the seconds of each
              step-0 sub-stage and each step.
    step2   — steps 2-3 on phase 3's features with the fused loop, the
              stepwise loop (PANGAEA_TRAIN_LOOP=stepwise) and bfloat16
              matmuls: fused and stepwise stop at the same epoch with val
              histories bit-equal (else within 1e-4 relative) and
              cross-ARI >= 0.95; bfloat16 reaches ARI >= 0.5 and
              cross-ARI >= 0.95 against float32. Prints evals, last
              epoch, phase_times and the step seconds of each, and the
              seconds of the first torch.optim.Adam() in a fresh process
              (a one-time cost the process's first step 2 pays).
11. parallel — pangaea_tpu_torch.parallel on cuda at world size 1 on NCCL
              (a FileStore rendezvous in build/smoke; one card, so no
              multi-rank NCCL run): the
              ShardedFeatureExtractor on phase 3's file (k = 15), at
              k = 21 and on the paired files (the weighted routed join),
              CSV bytes equal to phases 3, 8 and 6, each launching the
              cumsum of the owner's run ids and the cummax of the
              forward fill (no cummin_reverse); the key-range-sharded
              4^15 table path (no scan), byte-equal to phase 3;
              sharded_lloyd on phase 3's latent against kmeans_lloyd
              (same iterations, cross-ARI >= 0.95); four fused-loop
              units through sharded_unit_chunk against the one-device
              units (same improved/stop flags, val within 1e-3); then
              step 1 at k = 31 on two spawned gloo CPU ranks, byte-equal
              to phase 8's card run, joined under a timeout.
12. merge   — python -m pangaea_tpu_torch.pipeline.merge <root>
              metaspades --device cuda on a root built from phase 7's
              output (seed = its final_asm.fa, Athena's files cut from
              it): the builtin containment filter launches cummax, every
              file equals the same merge with --device cpu, and
              merged_out.fasta keeps >= 8 contigs and >= 800,000 bases.
    trace   — step 1 at k = 31 through Pipeline.run with
              PANGAEA_TPU_TRACE set: one Chrome trace whose CUDA kernel
              events include scan_kernel; prints the busiest kernels and
              the device busy share of the 'pipeline' range.

Every path's launch counts are zeroed just before it and read just
after it. After the phases, cummax and cummin_reverse are timed at the
main path's scan length, cumsum at the paired path's, all three again at
the k = 21 path's, and cummax at the mapper's flat (65,536 x 244) length
on a real run-boundary array, beside torch.cummax along its rows, and
at the hybrid mapper's first batch likewise; cumsum is also timed at
2^28 in phase 2. Every time is the median CUDA-event time of one call. A JSON line gives copy_ms, the time of one device-to-device
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


def stlfr_data(name: str, sim: dict) -> tuple:
    """Raw stLFR R1/R2 and whitelist made by simulate_stlfr_raw from the
    seed in ``sim``; reused like sim_data's. Returns ((r1, r2, wl),
    translated barcode -> species)."""
    from pangaea_tpu_torch.io.sim import simulate_stlfr_raw
    d = os.path.join(smoke_dir(), name)
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, f) for f in ("r1.fq", "r2.fq", "wl.txt")]
    meta = os.path.join(d, "truth.json")
    if os.path.exists(meta):
        with open(meta) as f:
            saved = json.load(f)
        if saved["sim"] == sim and all(map(os.path.exists, paths)):
            log(f"{name}: reusing {paths}")
            return paths, saved["virtual_species"]
    t0 = time.perf_counter()
    tmps = [p + ".tmp" for p in paths]
    res = simulate_stlfr_raw(*tmps, **sim)
    for tmp, path in zip(tmps, paths):
        os.replace(tmp, path)
    with open(meta, "w") as f:
        json.dump({"sim": sim, "virtual_species": res.virtual_species}, f)
    log(f"{name}: simulated {2 * res.n_pairs} raw stLFR reads "
        f"({res.n_unassigned} pairs unassigned) in "
        f"{time.perf_counter() - t0:.1f} s")
    return paths, res.virtual_species


def simulate_all(jobs: list) -> list:
    """Every (function, args) in ``jobs`` at once (sim_data, stlfr_data),
    one spawned process each: the simulators are single-threaded host
    Python and gzip, and nothing else runs meanwhile."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(jobs), mp_context=ctx) as pool:
        futures = [pool.submit(fn, *args) for fn, args in jobs]
        return [f.result() for f in futures]


def read_clusters(tsv: str) -> dict:
    out = {}
    with open(tsv) as f:
        for line in f:
            cid, bcs = line.rstrip("\n").split("\t")
            for bc in bcs.split(","):
                out[bc] = int(cid)
    return out


def cluster_ari(out: str, truth: dict) -> tuple:
    """(ARI of ``out``'s clusters.tsv vs truth, labelled barcodes,
    barcode -> cluster)."""
    from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
    clusters = read_clusters(os.path.join(out, "3.clustering",
                                          "clusters.tsv"))
    labelled = [bc for bc in clusters if bc in truth]
    ari = adjusted_rand_score([truth[bc] for bc in labelled],
                              [clusters[bc] for bc in labelled])
    return ari, len(labelled), clusters


def train_line(stats: dict) -> str:
    """Step 2's stop epoch, evals and the fused loop's phase_times."""
    hist = stats["val_history"]
    pt = stats["phase_times"]
    times = ({k: (round(v, 3) if isinstance(v, float) else v)
              for k, v in pt.items()} if pt else "stepwise")
    return (f"{len(hist)} evals, last at epoch {hist[-1][0] if hist else 0}"
            f"; set-up {stats['setup_s']:.3f} s, fit {stats['fit_s']:.3f} s,"
            f" latent {stats['latent_s']:.3f} s; phase_times {times}")


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
    ari, n_labelled, clusters = cluster_ari(out, truth)
    bins = sorted(f for f in os.listdir(os.path.join(out, "3.clustering"))
                  if f.endswith(".fq"))
    latent = np.load(os.path.join(out, "2.vae", "latent.npz"))["arr_0"]
    log(f"{what}: steps 1-3 on cuda in {wall:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()))
    log_stats(what, stats)
    log(f"{what}: step 2 (fused loop): {train_line(pipe.train_stats)}")
    log(f"{what}: scan launches {launches}; {len(clusters)} barcodes "
        f"clustered, latent {latent.shape}, {len(bins)} bin FASTQs; "
        f"ARI vs truth {ari:.6f} on {n_labelled} labelled barcodes")
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
    ari, n_labelled, clusters = cluster_ari(out, truth)
    k = st["k"]
    sizes = [len(p) for p, _ in st["skeletons"]]
    log(f"auto-k: step 3 without -c on cuda in {wall:.3f} s; k = {k} by "
        f"{st['k_source']} ({len(set(clusters.values()))} clusters); "
        f"{len(sizes)} reductions on the card {st['reduce_s']:.3f} s to "
        f"skeletons of {sizes} points, {st['n_fits']} skeleton fits in "
        f"{st['workers']} workers {st['fits_s']:.3f} s (os.cpu_count() "
        f"{os.cpu_count()}), final RPH-KMeans {st['rph_s']:.3f} s; scan "
        f"launches {launches}; ARI vs truth {ari:.6f} on {n_labelled} "
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


# ---- phase 10 ------------------------------------------------------------

# raw stLFR at the smoke's geometry: 10,000 partitions x 40 pairs of 150 bp
STLFR_SIM = dict(n_species=8, genome_len=200_000, n_partitions=10_000,
                 pairs_per_partition=40, read_len=150, n_wl=1536, seed=7)
TELLSEQ_PAIRS = 100_000   # phase 3's first pairs behind the Tell-Seq files
TELLSEQ_SHORT_EVERY = 1_000   # every 1000th pair: a 17-bp barcode, dropped
HYBRID_PAIRS = 100_000    # phase 6's first pairs, mapped to the long reads
LONG_READ_LEN = 10_000    # long reads cut from phase 7's final_asm.fa
BARCODED_GATE = 0.9       # share of hybrid pairs that must get a barcode
# fused against stepwise step 2: the same kernels on the same inputs in
# the same order; the tolerance only admits float sums that some kernel
# reorders between runs
HISTORY_RTOL = 1e-4
CROSS_ARI_GATE = 0.95


def iter_records(path: str):
    """4-line FASTQ records of a plain or gzipped file, as bytes."""
    import gzip
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        it = iter(f)
        for head in it:
            yield head + next(it) + next(it) + next(it)


def sorted_tags(what: str, sorted_fq: str) -> list:
    """The sort key of every pair of a barcode-sorted FASTQ (its BX:Z
    token, ``~~~`` when absent), checked non-decreasing in byte order
    with the unbarcoded last."""
    import re
    bx = re.compile(rb"BX:Z:[^ \t\r\n]*")
    tags = []
    for i, rec in enumerate(iter_records(sorted_fq)):
        if i % 2 == 0:
            m = bx.search(rec.split(b"\n", 1)[0])
            tags.append(m.group(0) if m else b"~~~")
    if any(a > b for a, b in zip(tags, tags[1:])):
        raise AssertionError(f"{what}: the sorted FASTQ's tags decrease")
    return tags


def run_driver(what: str, argv: list, kernels, absent=()) -> dict:
    """driver.main(argv + ["--device", "cuda"]) with the launch counts
    zeroed just before and checked just after; the driver's log handlers
    are taken off again."""
    import logging
    import torch
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import driver
    root = logging.getLogger()
    before = list(root.handlers)
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = driver.main(argv + ["--device", "cuda"])
    finally:
        for h in root.handlers[:]:
            if h not in before:
                root.removeHandler(h)
                h.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check_launched(what, launches, kernels, absent)
    out = argv[argv.index("-o") + 1]
    steps = {k: round(v.seconds, 3)
             for k, v in res["pipeline"].timer.stages.items()}
    step0 = {k: round(v, 3) for k, v in res["step0_s"].items()}
    log(f"{what}: driver on cuda in {wall:.3f} s; step 0 {step0}; steps "
        f"{steps}; scan launches {launches}")
    if res["pipeline"].feature_extractor is not None:
        log_stats(what, res["pipeline"].feature_extractor.stats)
    return {"out": out, "wall_s": wall, "launches": launches,
            "pipeline": res["pipeline"],
            "sorted": os.path.join(out, "0_preprocess_reads",
                                   "interleaved_link_reads.sorted.fastq")}


def driver_10x(r1: str, r2: str, truth: dict) -> dict:
    """-s 10x on phase 6's paired FASTQs: the sorted FASTQ holds the
    input's records (a multiset), its tags sorted, unbarcoded last; GNU
    sort gives the native sort's bytes; steps 1-3 reach the ARI gate."""
    import filecmp
    from pangaea_tpu_torch.io.fastq import barcode_sort_interleaved
    from pangaea_tpu_torch.io.preprocess import interleave
    out = os.path.join(smoke_dir(), "driver_10x")
    shutil.rmtree(out, ignore_errors=True)
    run = run_driver("driver-10x", [
        "-s", "10x", "-1", r1, "-2", r2, "-o", out, "-c", str(N_CLUSTERS),
        "-t", str(os.cpu_count() or 1), "-st", "1,2,3", "--skip-external"],
        FILL_SCANS)
    want = sorted(hash(r) for p in (r1, r2) for r in iter_records(p))
    got = sorted(hash(r) for r in iter_records(run["sorted"]))
    if got != want:
        raise AssertionError(f"driver-10x: the sorted FASTQ holds "
                             f"{len(got)} records, not the input's "
                             f"{len(want)}")
    tags = sorted_tags("driver-10x", run["sorted"])
    tmp = os.path.join(smoke_dir(), "driver_10x_gnu")
    t0 = time.perf_counter()
    interleave(r1, r2, tmp + ".in")
    t1 = time.perf_counter()
    barcode_sort_interleaved(tmp + ".in", tmp + ".fq", backend="gnu")
    t2 = time.perf_counter()
    same = filecmp.cmp(tmp + ".fq", run["sorted"], shallow=False)
    for f in (tmp + ".in", tmp + ".fq"):
        os.remove(f)
    if not same:
        raise AssertionError("driver-10x: GNU sort's bytes differ from the "
                             "native sort's")
    ari, n_labelled, _ = cluster_ari(out, truth)
    log(f"driver-10x: {len(got)} records sorted ({tags.count(b'~~~')} "
        f"unbarcoded pairs last), native = GNU sort bytes (GNU sort "
        f"{t2 - t1:.3f} s after a {t1 - t0:.3f} s interleave); step 2 "
        f"{train_line(run['pipeline'].train_stats)}; ARI vs truth "
        f"{ari:.6f} on {n_labelled} labelled barcodes")
    if ari < ARI_GATE:
        raise AssertionError(f"driver-10x: ARI {ari} below {ARI_GATE}")
    return run


def driver_stlfr(paths: list, truth: dict) -> dict:
    """-s stlfr -w on the raw stLFR simulation: steps 1-3 reach the ARI
    gate against the simulator's translated barcodes."""
    r1, r2, wl = paths
    out = os.path.join(smoke_dir(), "driver_stlfr")
    shutil.rmtree(out, ignore_errors=True)
    run = run_driver("driver-stlfr", [
        "-s", "stlfr", "-1", r1, "-2", r2, "-w", wl, "-o", out,
        "-c", str(N_CLUSTERS), "-t", str(os.cpu_count() or 1),
        "-st", "1,2,3", "--skip-external"], FILL_SCANS)
    tags = sorted_tags("driver-stlfr", run["sorted"])
    ari, n_labelled, clusters = cluster_ari(out, truth)
    log(f"driver-stlfr: {2 * len(tags)} records sorted "
        f"({tags.count(b'~~~')} unbarcoded pairs last), {len(clusters)} "
        f"barcodes clustered; step 2 "
        f"{train_line(run['pipeline'].train_stats)}; ARI vs truth "
        f"{ari:.6f} on {n_labelled} labelled barcodes")
    if ari < ARI_GATE:
        raise AssertionError(f"driver-stlfr: ARI {ari} below {ARI_GATE}")
    return run


def driver_tellseq(fq: str) -> dict:
    """-s tellseq -I, step 0 only, on R1/R2/I1 written from phase 3's
    first TELLSEQ_PAIRS pairs with 18-bp barcodes (the 16-bp barcode +
    "GT"; every TELLSEQ_SHORT_EVERY-th a 17-bp one, which step 0 drops):
    the record count and every record's BX tag."""
    d = os.path.join(smoke_dir(), "tellseq_in")
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, f) for f in ("r1.fq", "r2.fq", "i1.fq")]
    expect = {}
    it = iter_records(fq)
    with open(paths[0], "wb") as f1, open(paths[1], "wb") as f2, \
            open(paths[2], "wb") as fi:
        for i in range(TELLSEQ_PAIRS):
            a, b = next(it), next(it)
            head = a.split(b"\n", 1)[0][1:].decode()
            name, bc = head.split("\t")[0], head.split("BX:Z:")[1][:16]
            bc18 = bc[:17] if i % TELLSEQ_SHORT_EVERY == 7 else bc + "GT"
            if len(bc18) == 18:
                expect[name] = bc18
            for f, rec, mate in ((f1, a, 1), (f2, b, 2)):
                lines = rec.split(b"\n")
                f.write(f"@{name} {mate}:N:0:1\n".encode() + b"\n".join(
                    lines[1:]))
            fi.write(f"@{name} 1:N:0:1\n{bc18}\n+\n{'F' * len(bc18)}\n"
                     .encode())
    out = os.path.join(smoke_dir(), "driver_tellseq")
    shutil.rmtree(out, ignore_errors=True)
    run = run_driver("driver-tellseq", [
        "-s", "tellseq", "-1", paths[0], "-2", paths[1], "-I", paths[2],
        "-o", out, "-st", "0"], (), ALL_SCANS)
    n = 0
    for rec in iter_records(run["sorted"]):
        head = rec.split(b"\n", 1)[0][1:].decode()
        name, _, tag = head.partition("\tBX:Z:")
        if expect.get(name) is None or tag != expect[name] + "-1":
            raise AssertionError(f"driver-tellseq: record {n} {head!r} "
                                 f"carries the wrong tag")
        n += 1
    sorted_tags("driver-tellseq", run["sorted"])
    log(f"driver-tellseq: {n} records sorted of {2 * TELLSEQ_PAIRS} "
        f"written ({TELLSEQ_PAIRS - len(expect)} pairs with a 17-bp "
        f"barcode dropped), every BX tag the 18-bp barcode + '-1'")
    if n != 2 * len(expect):
        raise AssertionError(f"driver-tellseq: {n} records, expected "
                             f"{2 * len(expect)}")
    return run


def driver_hybrid(contigs_fa: str, r1: str, r2: str) -> dict:
    """-s short -l, step 0 only: long reads cut from phase 7's contigs,
    the short reads phase 6's first HYBRID_PAIRS pairs; no bwa on the
    card's machine, so the builtin k-mer vote mapper runs on cuda (the
    CUDA cummax must launch). At least BARCODED_GATE of the pairs get a
    virtual barcode; the tags are sorted. Returns the run and the
    run-boundary array of the mapper's first batch."""
    import itertools
    from pangaea_tpu_torch.asm.fasta import iter_fasta
    from pangaea_tpu_torch.asm.mapper import (KmerMapper, run_boundaries,
                                              sorted_row_ids)
    d = os.path.join(smoke_dir(), "hybrid_in")
    os.makedirs(d, exist_ok=True)
    longreads = os.path.join(d, "long.fa")
    lengths = []
    with open(longreads, "w") as f:
        for name, seq in iter_fasta(contigs_fa):
            for lo in range(0, len(seq), LONG_READ_LEN):
                piece = seq[lo:lo + LONG_READ_LEN]
                f.write(f">long_{len(lengths)} {name.split()[0]}:{lo}\n"
                        f"{piece}\n")
                lengths.append(len(piece))
    shorts = [os.path.join(d, f) for f in ("s1.fq", "s2.fq")]
    for src, dst in zip((r1, r2), shorts):
        with open(dst, "wb") as f:
            f.writelines(itertools.islice(iter_records(src), HYBRID_PAIRS))
    out = os.path.join(smoke_dir(), "driver_hybrid")
    shutil.rmtree(out, ignore_errors=True)
    run = run_driver("driver-hybrid", [
        "-s", "short", "-1", shorts[0], "-2", shorts[1], "-l", longreads,
        "-o", out, "-st", "0"], ("cummax",), ("cummin_reverse", "cumsum"))
    tags = sorted_tags("driver-hybrid", run["sorted"])
    share = 1.0 - tags.count(b"~~~") / max(len(tags), 1)
    log(f"driver-hybrid: {len(lengths)} long reads of up to "
        f"{LONG_READ_LEN} bp ({sum(lengths)} bases), {len(tags)} short "
        f"pairs; {share:.6f} of the pairs carry a virtual barcode, "
        f"{len(set(tags)) - (b'~~~' in tags)} distinct")
    if len(tags) != HYBRID_PAIRS or share < BARCODED_GATE:
        raise AssertionError(f"driver-hybrid: {len(tags)} pairs, barcoded "
                             f"share {share} (gate {BARCODED_GATE})")
    m = KmerMapper(max_row_len=4096, device="cuda")
    m.index_contigs([(n.split()[0], s) for n, s in iter_fasta(longreads)])
    seqs = [rec.split(b"\n")[1].decode() for rec in itertools.islice(
        iter_records(shorts[0]), MAP_BATCH_PAIRS * 2)]
    s, _ = sorted_row_ids(m.table, *m.encode_reads(seqs), k=m.k)
    run["boundary"] = run_boundaries(s)[1]
    del m
    return run


def phase_driver(paired: tuple, ptruth: dict, stlfr: tuple, fq: str,
                 contigs_fa: str) -> dict:
    (r1, r2), (paths, vtruth) = paired, stlfr
    return {"driver-10x": driver_10x(r1, r2, ptruth),
            "driver-stlfr": driver_stlfr(paths, vtruth),
            "driver-tellseq": driver_tellseq(fq),
            "driver-hybrid": driver_hybrid(contigs_fa, r1, r2)}


FIRST_OPTIMIZER = (
    "import sys, time\n"
    "t0 = time.perf_counter()\n"
    "import torch\n"
    "w = [torch.zeros(4, device='cuda', requires_grad=True)]\n"
    "torch.cuda.synchronize()\n"
    "t1 = time.perf_counter()\n"
    "torch.optim.Adam(w)\n"
    "t2 = time.perf_counter()\n"
    "torch.optim.Adam(w)\n"
    "print(t1 - t0, t2 - t1, time.perf_counter() - t2,\n"
    "      'torch._dynamo' in sys.modules)\n")


def first_optimizer_line() -> str:
    """The seconds of `import torch` (with the card's set-up), of the
    first torch.optim.Adam() and of a second one in a fresh process on
    this machine, and whether the first loaded torch._dynamo."""
    out = subprocess.run([sys.executable, "-c", FIRST_OPTIMIZER],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"first-optimizer probe failed: {out.stderr}")
    imp, first, second, dynamo = out.stdout.split()
    return (f"a fresh process: import torch and the card {float(imp):.3f} "
            f"s, first "
            f"torch.optim.Adam() {float(first):.3f} s (torch._dynamo "
            f"loaded: {dynamo}), a second {float(second):.4f} s")


def phase_step2(run: dict, fq: str, truth: dict) -> dict:
    """Steps 2-3 on phase 3's features three ways on cuda: the fused loop
    (the default), the stepwise loop (PANGAEA_TRAIN_LOOP=stepwise) and
    bfloat16 matmuls. Fused against stepwise: the same stop epoch and
    val history (bit-equal, else within HISTORY_RTOL) and cross-ARI >=
    CROSS_ARI_GATE; bf16: ARI >= ARI_GATE and cross-ARI against the
    fused run >= CROSS_ARI_GATE."""
    import numpy as np
    import torch
    from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
    from pangaea_tpu_torch.config import ClusterConfig, PangaeaConfig
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import Pipeline
    runs = {}
    for name, loop, dtype in (("fused", "fused", "float32"),
                              ("stepwise", "stepwise", "float32"),
                              ("bf16", "fused", "bfloat16")):
        out = os.path.join(smoke_dir(), f"step2_{name}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(run["feature_dir"], os.path.join(out, "1.features"))
        cfg = PangaeaConfig(interleaved_reads=fq, output=out, steps="2,3",
                            cluster=ClusterConfig(n_clusters=N_CLUSTERS))
        cfg.model.matmul_dtype = dtype
        os.environ["PANGAEA_TRAIN_LOOP"] = loop
        try:
            pipe = Pipeline(cfg, device="cuda")
            scan.reset_launches()
            torch.cuda.synchronize()
            pipe.run()
            torch.cuda.synchronize()
        finally:
            del os.environ["PANGAEA_TRAIN_LOOP"]
        check_launched(f"step2-{name}", launch_counts(), (), ALL_SCANS)
        ari, n_labelled, clusters = cluster_ari(out, truth)
        secs = {k: round(v.seconds, 3) for k, v in pipe.timer.stages.items()}
        log(f"step2-{name}: {secs}; {train_line(pipe.train_stats)}; ARI vs "
            f"truth {ari:.6f} on {n_labelled} labelled barcodes")
        runs[name] = {"hist": pipe.train_stats["val_history"],
                      "clusters": clusters, "ari": ari, "secs": secs}

    def cross(a: str, b: str) -> float:
        ca, cb = runs[a]["clusters"], runs[b]["clusters"]
        common = sorted(set(ca) & set(cb))
        return adjusted_rand_score([ca[x] for x in common],
                                   [cb[x] for x in common])

    hf, hs = runs["fused"]["hist"], runs["stepwise"]["hist"]
    same_points = [h[:2] for h in hf] == [h[:2] for h in hs]
    vf = np.asarray([h[2] for h in hf], np.float64)
    vs = np.asarray([h[2] for h in hs], np.float64)
    bit_equal = same_points and np.array_equal(vf, vs)
    rel = (float(np.max(np.abs(vf - vs) / np.abs(vs), initial=0.0))
           if same_points else float("inf"))
    x_loops, x_bf16 = cross("fused", "stepwise"), cross("fused", "bf16")
    log(f"step2: fused vs stepwise on cuda: {len(hf)} vs {len(hs)} evals, "
        f"stop epochs {hf[-1][0]} vs {hs[-1][0]}, val histories bit-equal: "
        f"{bit_equal} (largest relative difference {rel:.3e}), cross-ARI "
        f"{x_loops:.6f}; bf16 ARI {runs['bf16']['ari']:.6f}, cross-ARI vs "
        f"fused float32 {x_bf16:.6f}")
    if not same_points or rel > HISTORY_RTOL or x_loops < CROSS_ARI_GATE:
        raise AssertionError("step2: the fused loop departs from the "
                             "stepwise loop on the card")
    if runs["bf16"]["ari"] < ARI_GATE or x_bf16 < CROSS_ARI_GATE:
        raise AssertionError("step2: bfloat16 below its ARI gates")
    log(f"step2: {first_optimizer_line()}")
    return runs


# ---- phase 11 ------------------------------------------------------------

SHARD_SCANS = ("cumsum", "cummax")   # the routed join: owner run ids, fill
UNITS_C, UNITS_U, UNITS_VNB = 4, 2, 2  # sharded_unit_chunk's units
UNIT_VAL_RTOL = 1e-3
GLOO_WORLD = 2
GLOO_TIMEOUT_S = 600


def csv_bytes(fe) -> tuple:
    """The decompressed bytes of an extractor's two CSVs."""
    import gzip
    out = []
    for p in (fe.abd_gz, fe.tnf_gz):
        with gzip.open(p) as f:
            out.append(f.read())
    return tuple(out)


def expected_csvs(feature_dir: str, cfg) -> tuple:
    from pangaea_tpu_torch.features import FeatureExtractor
    return csv_bytes(FeatureExtractor(cfg, feature_dir, device="cpu"))


def run_sharded_step1(what: str, inputs: dict, cfg, expect_dir: str,
                      kernels, absent=()) -> dict:
    """ShardedFeatureExtractor on cuda (world size 1, NCCL) with the
    launch counts zeroed just before: its CSV bytes must equal those in
    ``expect_dir`` (an earlier phase's one-device run). The one-device
    FeatureExtractor runs the same config first, timed alike (both
    write their CSVs before returning)."""
    import torch
    from pangaea_tpu_torch.features import FeatureExtractor
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.parallel import ShardedFeatureExtractor
    d = os.path.join(smoke_dir(), what)
    one = d + "-one-device"
    for p in (d, one):
        shutil.rmtree(p, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    FeatureExtractor(cfg, one, device="cuda").extract_features(**inputs)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    fe = ShardedFeatureExtractor(cfg, d, device="cuda")
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names, _, _ = fe.extract_features(**inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    log(f"{what}: sharded step 1 on cuda (world size 1, nccl) in "
        f"{secs:.3f} s (one device {one_s:.3f} s); scan launches "
        f"{launches}")
    log_stats(what, fe.stats)
    check_launched(what, launches, kernels, absent)
    if csv_bytes(fe) != expected_csvs(expect_dir, cfg):
        raise AssertionError(f"{what}: CSV bytes differ from {expect_dir}")
    log(f"{what}: {len(names)} barcodes, CSVs byte-equal to {expect_dir}")
    return {"launches": launches, "seconds": secs, "one_device_s": one_s,
            "stats": dict(fe.stats)}


def check_sharded_lloyd(run: dict) -> dict:
    """sharded_lloyd on phase 3's latent against the one-device
    kmeans_lloyd from the same 8 initial centres: the same iterations,
    cross-ARI >= CROSS_ARI_GATE."""
    import numpy as np
    import torch
    from pangaea_tpu_torch.cluster.kmeans import kmeans_lloyd
    from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.parallel import sharded_lloyd
    emb = np.load(os.path.join(run["out"], "2.vae", "latent.npz"))["arr_0"]
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    init = emb[np.random.RandomState(0).choice(len(emb), N_CLUSTERS,
                                               replace=False)]
    t0 = time.perf_counter()
    _, l1, in1, it1 = kmeans_lloyd(emb, init, device="cuda")
    t1 = time.perf_counter()
    lloyd = sharded_lloyd(device="cuda")
    x = torch.from_numpy(emb).cuda()
    tol = np.float32(1e-4 * np.mean(np.var(emb, axis=0)))
    scan.reset_launches()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, l2, in2, it2 = lloyd(x, torch.ones(len(emb), device="cuda"),
                            torch.from_numpy(init).cuda(),
                            torch.tensor(tol, device="cuda"))
    l2 = l2.cpu().numpy()
    secs = time.perf_counter() - t2
    launches = launch_counts()
    check_launched("sharded-lloyd", launches, (), ALL_SCANS)
    ari = adjusted_rand_score(l1, l2)
    log(f"sharded-lloyd: {emb.shape} latent, {it2} iterations in {secs:.3f}"
        f" s (one device {it1} in {t1 - t0:.3f} s), inertia "
        f"{float(in2):.6f} vs {float(in1):.6f}, cross-ARI {ari:.6f}")
    if it1 != it2 or ari < CROSS_ARI_GATE:
        raise AssertionError("sharded-lloyd: departs from the one-device "
                             "fit")
    return {"seconds": secs, "launches": launches}


def check_sharded_units(run: dict) -> dict:
    """UNITS_C fused-loop units of phase 3's features at pangaea_tpu's
    model defaults (patience 2, a partial train batch and a partial val
    batch) through sharded_unit_chunk and through the one-device
    _run_unit, from the same weights and generator: the same improved
    and stop flags, val losses within UNIT_VAL_RTOL."""
    import numpy as np
    import torch
    from pangaea_tpu_torch.config import ModelConfig
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.model import BarcodeDataset, VAE, VAETrainer
    from pangaea_tpu_torch.model.train import FusedState
    from pangaea_tpu_torch.parallel import sharded_unit_chunk
    ds = BarcodeDataset(*load_features(run["feature_dir"]))
    m = ModelConfig(patience=2)
    n, bsz = len(ds), min(m.batch_size, len(ds))
    rng = np.random.RandomState(0)
    uidx = rng.randint(0, n, (UNITS_C, UNITS_U, bsz))
    ucnt = np.full((UNITS_C, UNITS_U), bsz)
    ucnt[-1, -1] = bsz // 2 + 1
    vidx = rng.randint(0, n, (UNITS_C, UNITS_VNB, bsz))
    vcnt = [bsz, bsz // 3]
    abd, tnf = (torch.from_numpy(a).cuda() for a in (ds.abd, ds.tnf))

    def trainer():
        model = VAE(ds.abd_dim, ds.tnf_dim, hidden_sizes=m.hidden_sizes,
                    latent_dim=m.latent_dim, dropout=m.dropout,
                    generator=torch.Generator().manual_seed(m.seed))
        tr = VAETrainer(model, m, device="cuda")
        return tr, FusedState(tr.model, m, tr.device), tr.optimizer(), \
            tr._generator(1)

    tr, es, opt, gen = trainer()
    rows1 = torch.zeros((UNITS_C, 8), device="cuda")
    t0 = time.perf_counter()
    u_dev = torch.from_numpy(uidx).cuda()
    v_dev = torch.from_numpy(vidx).cuda()
    for i in range(UNITS_C):
        if bool(es.stopped):
            rows1[i, 6] = 1.0
            continue
        rows1[i], _ = tr._run_unit(es, opt, gen, abd, tnf, ucnt[i].tolist(),
                                   u_dev[i], v_dev[i], vcnt)
    rows1 = rows1.cpu().numpy()
    t1 = time.perf_counter()
    tr, es, opt, gen = trainer()
    chunk = sharded_unit_chunk(tr, device="cuda")
    scan.reset_launches()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rows2 = chunk(es, opt, gen, abd, tnf, uidx, ucnt, np.ones(UNITS_C, bool),
                  vidx, vcnt).cpu().numpy()
    secs = time.perf_counter() - t2
    launches = launch_counts()
    check_launched("sharded-units", launches, (), ALL_SCANS)
    ran = rows2[:, 7] != 0
    rel = float(np.max(np.abs(rows2[ran, 0] - rows1[ran, 0])
                       / np.abs(rows1[ran, 0]), initial=0.0))
    log(f"sharded-units: {UNITS_C} units of {UNITS_U} x {bsz} rows on "
        f"cuda in {secs:.3f} s (one device {t1 - t0:.3f} s); val "
        f"{rows2[ran, 0].tolist()} vs {rows1[ran, 0].tolist()} (largest "
        f"relative difference {rel:.3e}); improved "
        f"{rows2[:, 5].tolist()}, stop {rows2[:, 6].tolist()}")
    if not (np.array_equal(rows1[:, 5:8] != 0, rows2[:, 5:8] != 0)
            and rel <= UNIT_VAL_RTOL):
        raise AssertionError("sharded-units: depart from the one-device "
                             "units")
    return {"seconds": secs, "launches": launches}


def gloo_rank(rank: int, world: int, store: str, fq: str, out: str) -> None:
    """One CPU rank of the gloo step-1 run (a spawned process)."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    import torch.distributed as dist
    from pangaea_tpu_torch.config import FeatureConfig, ParallelConfig
    from pangaea_tpu_torch.parallel import (ShardedFeatureExtractor,
                                            initialize_distributed)
    initialize_distributed(ParallelConfig(
        use_distributed=True, coordinator_address=f"file://{store}",
        num_processes=world, process_id=rank), device="cpu")
    fe = ShardedFeatureExtractor(FeatureConfig(kmer=31), out, device="cpu")
    fe.extract_features(interleaved=fq)
    dist.destroy_process_group()


def check_gloo_step1(fq31: str, k31_dir: str) -> float:
    """Step 1 at k = 31 on GLOO_WORLD spawned CPU ranks (gloo): CSV bytes
    equal to phase 8's k = 31 run on the card; the ranks are joined
    under GLOO_TIMEOUT_S and killed on it."""
    import multiprocessing
    from pangaea_tpu_torch.config import FeatureConfig
    out = os.path.join(smoke_dir(), "parallel-gloo")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    store = os.path.join(out, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank,
                         args=(r, GLOO_WORLD, store, fq31, out))
             for r in range(GLOO_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"parallel-gloo: ranks did not finish "
                                     f"in {GLOO_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    secs = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"parallel-gloo: rank exit codes "
                             f"{[p.exitcode for p in procs]}")
    from pangaea_tpu_torch.features import FeatureExtractor
    cfg = FeatureConfig(kmer=31)
    got = csv_bytes(FeatureExtractor(cfg, out, device="cpu"))
    if got != expected_csvs(k31_dir, cfg):
        raise AssertionError("parallel-gloo: CSV bytes differ from the "
                             "card's k = 31 run")
    log(f"parallel-gloo: step 1 at k = 31 on {GLOO_WORLD} gloo CPU ranks "
        f"in {secs:.3f} s (spawn and imports included), CSVs byte-equal "
        f"to the card's")
    return secs


def phase_parallel(fq: str, run: dict, r1: str, r2: str, paired: dict,
                   k21: dict, fq31: str) -> dict:
    """The sharded paths on cuda at world size 1 on NCCL (a FileStore
    rendezvous in build/smoke): ShardedFeatureExtractor on phase 3's
    file (k = 15), at k = 21 against phase 8, on the paired files
    (weighted join) against phase 6, the key-range-sharded 4^15 table
    path; sharded_lloyd and sharded_unit_chunk against one device; then
    step 1 at k = 31 on two gloo CPU ranks."""
    import torch.distributed as dist
    from pangaea_tpu_torch.config import FeatureConfig, ParallelConfig
    from pangaea_tpu_torch.parallel import initialize_distributed
    from pangaea_tpu_torch.pipeline import cli
    store = os.path.join(smoke_dir(), "nccl.store")
    if os.path.exists(store):
        os.remove(store)
    initialize_distributed(ParallelConfig(
        use_distributed=True, coordinator_address=f"file://{store}",
        num_processes=1, process_id=0), device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"parallel: backend {dist.get_backend()}")
    import torch
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device="cuda"))  # the communicator
    torch.cuda.synchronize()
    log(f"parallel: nccl group of 1 rank; first collective (communicator "
        f"set-up) {time.perf_counter() - t0:.3f} s")
    try:
        parser = cli.build_parser()
        pcfg = cli.config_from_args(parser.parse_args(
            ["-1", r1, "-2", r2, "-o", "unused", "-c", str(N_CLUSTERS)])
        ).feature
        paths = {
            "parallel-k15": run_sharded_step1(
                "parallel-k15", {"interleaved": fq}, FeatureConfig(),
                run["feature_dir"], SHARD_SCANS, ("cummin_reverse",)),
            "parallel-k21": run_sharded_step1(
                "parallel-k21", {"interleaved": fq},
                FeatureConfig(kmer=LARGE_K), k21["run"]["feature_dir"],
                SHARD_SCANS, ("cummin_reverse",)),
            "parallel-paired": run_sharded_step1(
                "parallel-paired", {"reads1": r1, "reads2": r2}, pcfg,
                paired["feature_dir"], SHARD_SCANS, ("cummin_reverse",)),
            "parallel-table": run_sharded_step1(
                "parallel-table", {"interleaved": fq},
                FeatureConfig(hist_impl="scatter"), run["feature_dir"], (),
                ALL_SCANS),
        }
        paths["parallel-lloyd"] = check_sharded_lloyd(run)
        paths["parallel-units"] = check_sharded_units(run)
    finally:
        dist.destroy_process_group()
    gloo_s = check_gloo_step1(fq31, os.path.join(smoke_dir(), "k31"))
    log("parallel: seconds " + json.dumps(
        {**{k: round(v["seconds"], 3) for k, v in paths.items()},
         "parallel-gloo": round(gloo_s, 3)}))
    return paths


# ---- phase 12 ------------------------------------------------------------

# Athena's local contigs: pieces short enough for the builtin containment
# filter to find contained (the mapper reads 1,024 bp of each; 1,000 bp
# of slack), cut every 20 kb
ATHENA_PIECE, ATHENA_STRIDE = 1_500, 20_000


def merge_root(root: str, out: str) -> None:
    """A driver-layout run root from phase 7's run ``out``: the seed
    (1_metaspades_out) is its final_asm.fa, the binned contigs and the
    low-abundance reassemblies are its own, and Athena's local contigs
    are ATHENA_PIECE-bp pieces cut every ATHENA_STRIDE bp from
    final_asm.fa plus one seeded random 5 kb contig (athena.asm.fa: each
    contig's first half)."""
    import glob
    import numpy as np
    from pangaea_tpu_torch.asm.fasta import iter_fasta, write_fasta
    shutil.rmtree(root, ignore_errors=True)
    final = os.path.join(out, "final_asm.fa")
    os.makedirs(os.path.join(root, "1_metaspades_out"))
    shutil.copy(final, os.path.join(root, "1_metaspades_out",
                                    "contigs.fasta"))
    os.makedirs(os.path.join(root, "3.clustering"))
    shutil.copy(os.path.join(out, "3.clustering", "contigs.megahit.fa"),
                os.path.join(root, "3.clustering"))
    asm = os.path.join(root, "4.assembly")
    os.makedirs(asm)
    for p in (glob.glob(os.path.join(out, "4.assembly", "*.spades",
                                     "contigs.fasta"))
              + glob.glob(os.path.join(out, "4.assembly", "*.megahit",
                                       "final.contigs.fa"))):
        sub = os.path.join(asm, os.path.basename(os.path.dirname(p)))
        os.makedirs(sub)
        shutil.copy(p, sub)
    olc = os.path.join(root, "2_athena_out", "results", "olc")
    os.makedirs(olc)
    contigs = list(iter_fasta(final))
    pieces = [(f"{n.split()[0]}_{i}", s[i:i + ATHENA_PIECE])
              for n, s in contigs for i in range(0, len(s), ATHENA_STRIDE)]
    rng = np.random.RandomState(12)
    pieces.append(("random", "".join("ACGT"[i]
                                     for i in rng.randint(0, 4, 5000))))
    write_fasta(os.path.join(olc, "flye-input-contigs.fa"), pieces)
    write_fasta(os.path.join(olc, "athena.asm.fa"),
                [(n.split()[0], s[:len(s) // 2]) for n, s in contigs])


def phase_merge(run: dict) -> dict:
    """``python -m pangaea_tpu_torch.pipeline.merge <root> metaspades
    --device cuda`` on a root built from phase 7's output (without
    quickmerge on PATH, merged_out.fasta is the olc result): the builtin
    containment filter must launch cummax and drop pooled contigs (the
    pieces cut from the seed); every file the merge writes must be
    byte-equal to the same merge with device cpu on a second copy of the
    root; merged_out.fasta keeps >= ASM_MIN_CONTIGS contigs and >=
    ASM_MIN_BASES bases."""
    import torch
    from pangaea_tpu_torch.asm.fasta import iter_fasta
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import merge
    roots = {dev: os.path.join(smoke_dir(), f"merge_{dev}")
             for dev in ("cuda", "cpu")}
    for root in roots.values():
        merge_root(root, run["out"])
    scan.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merge.main([roots["cuda"], "metaspades", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    check_launched("merge", launches, ("cummax",))
    t1 = time.perf_counter()
    stats = {}
    merge.final_merge(roots["cpu"], "metaspades", device="cpu", stats=stats)
    cpu_s = time.perf_counter() - t1
    check_builtin("merge (cpu)", stats["backend"])

    def tree(root):
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = \
                        fh.read()
        return out

    if tree(roots["cuda"]) != tree(roots["cpu"]):
        raise AssertionError("merge: cuda and cpu merges differ")
    merged = os.path.join(roots["cuda"], "4.assembly",
                          "quickmerge_metaspades", "merged_out.fasta")
    lengths = [len(s) for _, s in iter_fasta(merged)]
    filt = os.path.join(roots["cuda"], "4.assembly", "olc_metaspades",
                        "pre-flye-input-contigs.filt.fa")
    pool = os.path.join(roots["cuda"], "4.assembly",
                        "contigs.low_abd.binning.local.fa")
    kept = sum(1 for _ in iter_fasta(filt))
    pooled = sum(1 for _ in iter_fasta(pool))
    log(f"merge: pipeline.merge metaspades on cuda in {secs:.3f} s (cpu "
        f"{cpu_s:.3f} s), byte-equal; {kept} of {pooled} pooled contigs "
        f"kept; merged_out.fasta {len(lengths)} contigs, {sum(lengths)} "
        f"bases; scan launches {launches}")
    if len(lengths) < ASM_MIN_CONTIGS or sum(lengths) < ASM_MIN_BASES:
        raise AssertionError(f"merge: {len(lengths)} contigs, "
                             f"{sum(lengths)} bases")
    if kept >= pooled:
        raise AssertionError("merge: the containment filter dropped none "
                             "of the pieces cut from the seed")
    return {"seconds": secs, "cpu_s": cpu_s, "launches": launches}


# ---- the traced step 1 ---------------------------------------------------

TRACE_TOP = 8


def phase_trace(fq31: str) -> dict:
    """Step 1 at k = 31 through Pipeline.run with PANGAEA_TPU_TRACE set:
    one Chrome trace whose CUDA kernel events include the scan kernel.
    Prints the kernels' count, the busiest kernels, and the device busy
    share — the union of kernel, copy and memset intervals over the
    'pipeline' range."""
    import torch
    from pangaea_tpu_torch.config import FeatureConfig, PangaeaConfig
    from pangaea_tpu_torch.kernels import scan
    from pangaea_tpu_torch.pipeline import Pipeline
    out = os.path.join(smoke_dir(), "trace_run")
    tdir = os.path.join(smoke_dir(), "trace")
    for d in (out, tdir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(out)
    cfg = PangaeaConfig(interleaved_reads=fq31, output=out, steps="1",
                        feature=FeatureConfig(kmer=31))
    os.environ["PANGAEA_TPU_TRACE"] = tdir
    try:
        pipe = Pipeline(cfg, device="cuda")
        scan.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        del os.environ["PANGAEA_TPU_TRACE"]
    launches = launch_counts()
    check_launched("trace", launches, FILL_SCANS)
    files = os.listdir(tdir)
    if len(files) != 1:
        raise AssertionError(f"trace: {files} in {tdir}")
    with open(os.path.join(tdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    scans = [e for e in kernels if "scan_kernel" in e.get("name", "")]
    if not kernels or not scans:
        raise AssertionError(f"trace: {len(kernels)} kernel events, "
                             f"{len(scans)} of the scan kernel")
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    union, end = 0.0, float("-inf")
    for a, b in busy:
        if b > end:
            union += b - max(a, end)
            end = b
    span = max((e["dur"] for e in events if e.get("name") == "pipeline"
                and "dur" in e), default=0.0)
    by_name = {}
    for e in kernels:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TRACE_TOP]
    log(f"trace: step 1 at k = 31 traced in {secs:.3f} s; {files[0]}: "
        f"{len(events)} events, {len(kernels)} kernels ({len(scans)} of "
        f"scan_kernel); device busy {union / 1e3:.3f} ms of the "
        f"{span / 1e3:.3f} ms pipeline range ({union / max(span, 1):.4f}); "
        f"scan launches {launches}")
    log("trace: busiest kernels (ms) " + json.dumps(
        {k: round(v / 1e3, 3) for k, v in top}))
    return {"seconds": secs, "launches": launches}


def mapper_cummax_record(boundary, launches: int,
                         path: str = "assembly") -> dict:
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
            "launches_by_path": {path: launches}, **r}


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
    ((fq,), truth), ((r1, r2), ptruth), ((fq31,), _), stlfr = phase(
        "simulate", simulate_all, [
            (sim_data, ("data", SIM, False)),
            (sim_data, ("data_paired", PAIRED_SIM, True)),
            (sim_data, ("data_k31", K31_SIM, False)),
            (stlfr_data, ("data_stlfr", STLFR_SIM))])
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
    drivers = phase("driver", phase_driver, (r1, r2), ptruth, stlfr, fq,
                    os.path.join(run["out"], "final_asm.fa"))
    phase("step2", phase_step2, run, fq, truth)
    shards = phase("parallel", phase_parallel, fq, run, r1, r2, paired, k21,
                   fq31)
    merged = phase("merge", phase_merge, run)
    traced = phase("trace", phase_trace, fq31)
    k21_paths = {"k21": k21["run"]["launches"],
                 **{k: v["launches"] for k, v in k21["paths"].items()},
                 "k31": k31["launches"]}
    by_path = {"pipeline": run["launches"],
               **{k: v["launches"] for k, v in spills.items()},
               "paired": paired["launches"],
               "paired-spill-agg": paired["spill"]["launches"],
               "assembly": asm["launches"], **k21_paths,
               **{k: v["launches"] for k, v in tables.items()},
               "auto-k": autok["launches"],
               **{k: v["launches"] for k, v in drivers.items()},
               **{k: v["launches"] for k, v in shards.items()},
               "merge": merged["launches"], "trace": traced["launches"]}
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
    hybrid = drivers["driver-hybrid"]
    n_hybrid = hybrid["boundary"].numel()
    records.append(mapper_cummax_record(hybrid.pop("boundary"),
                                        hybrid["launches"]["cummax"],
                                        "driver-hybrid"))
    copies = {str(n): copy_ms(n) for n in sorted({n_main, n_paired, n_k21,
                                                  n_map, n_hybrid,
                                                  SCAN_CAP})}
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
