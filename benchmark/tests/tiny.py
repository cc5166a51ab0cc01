"""A tiny copy of the benchmark's cells for CPU tests: the same files,
fewer barcodes, shorter genomes and training, in a temporary root."""

import contextlib
import io
import json
import os
import shutil
import time

from benchmark import run

ROOT = run.ROOT


def make_root(tmp, barcodes=160, epochs=20, clusters=4):
    """A checkout root holding BENCHMARK.json and cut-down data files
    (the platform modules and metric readers are copied as they are)."""
    root = os.path.join(str(tmp), "root")
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(root, "benchmark", sub))
    for sub in ("platforms", "metrics"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub),
                        os.path.join(root, "benchmark", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(genome_len=30000, molecule_len=8000)
        cfg["binning"].update(clusters=clusters, epochs=epochs, batch=64)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in man["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "traffic",
                               w["traffic"] + ".json")) as f:
            tr = json.load(f)
        tr.update(barcodes=barcodes, pairs_per_barcode=10)
        with open(os.path.join(root, "benchmark", "traffic",
                               w["traffic"] + ".json"), "w") as f:
            json.dump(tr, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def run_cell(root, cell, seed=2 ** 31 + 77, trace=0):
    """run.main on the CPU (no look for a card); (rc, last stdout line
    as a dict or None, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0", "--trace", str(trace)],
                      root=root, device="cpu", t_start=time.perf_counter())
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, out.getvalue(), err.getvalue()
