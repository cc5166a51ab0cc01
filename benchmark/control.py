"""Readings that set the limits of the comparison, at a cell's own size:

    python3 -m benchmark.control --workload 10x-atcc.bin --seeds 11 12 13

For each seed, in one process after one warm-up: one pass of the program
and its numbers against the float32 reference (the lower readings), the
control (the reference with TF32 matmuls in the program's place) judged
the same way, and the planted fault "a cluster label altered where it is
produced" (one barcode moved to another cluster) for ``centroid_excess``.
One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from benchmark import run as bench_run


def main(argv=None, *, root: str = bench_run.ROOT, device: str = "cuda"
         ) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench_run.cache_env(root)
    import numpy as np
    import torch
    from benchmark import compare, harness, reference

    cell = harness.load_cell(root, args.workload)
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    binning = cell.config["binning"]
    lloyd = harness.Step3Counts()
    for i, seed in enumerate(args.seeds):
        work = tempfile.mkdtemp(prefix="pangaea-control-")
        try:
            inp, warm = harness.make_inputs(cell, seed, work)
            if i == 0:
                harness.run_pass(cell, warm, os.path.join(work, "warmup"),
                                 device, lloyd)
            out = os.path.join(work, "pass")
            ps = harness.run_pass(cell, inp, out, device, lloyd)
            ps.count_outputs()
            ref = compare.build_reference(inp, binning, device)
            nums = compare.compare_pass(out, ref, binning)
            names, mu = reference.latent(ref.names, ref.abd, ref.tnf,
                                         binning, device, precision="tf32")
            ctrl = compare.latent_gap(names, mu, ref)
            pnames, _ = compare._program_latent(os.path.join(out, "2.vae"))
            labels = np.load(os.path.join(out, "3.clustering",
                                          "clusters.npz"))["arr_0"].copy()
            x = compare._aligned(pnames, ref)
            pick = np.random.default_rng(seed)
            j = int(pick.integers(len(labels)))
            others = np.setdiff1d(np.unique(labels), [labels[j]])
            labels[j] = others[pick.integers(len(others))]
            fault = reference.centroid_excess(x, labels)
            print(json.dumps({"seed": seed, "program": nums,
                              "control_latent_gap": ctrl,
                              "fault_centroid_excess": fault,
                              "work": ps.work(),
                              "pass_s": ps.seconds}), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lloyd.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
