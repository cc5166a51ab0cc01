"""One run of one cell: inputs from the seed, a warm-up, whole passes over
a measured window, the per-layer readings, and the comparison with the
plain reference.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the manifest's ``file``): the sample, the
  read geometry and the binning settings, with ``limits``, the limit of
  each number the comparison reads;
- ``traffic/<traffic>.json``: the entry a pass runs (``pipeline`` or
  ``driver``), its steps, and the barcodes and pairs per barcode;
- ``platforms/<platform>.py``, for the configuration's ``platform``: the
  input kind, loaded by its path (``gen.platform``). It imports nothing
  of the program and provides

  - ``simulate(cfg, traffic, seed) -> gen.Inputs``: the pass's pairs from
    the seed, drawn with ``gen.pairs`` (barcodes x pairs per barcode of
    the configuration's sample) and the platform's own draws after it;
    names, barcodes and files' order are the platform's. Arrays that fit
    no field of ``Inputs`` (long reads, an index read) go in
    ``Inputs.extra``;
  - ``write(inp, cfg, traffic, out_dir, prefix) -> dict``: writes the
    files a pass reads under ``out_dir``, each named from ``prefix``,
    and returns them by role (``interleaved``, ``r1``, ``r2``, ...);
  - ``subset(inp, keep_barcodes) -> gen.Inputs``: the warm-up slice, the
    pairs of the barcodes marked in the bool mask (``gen.take`` keeps
    what is not per pair), with whatever else the platform's files need;
  - ``stream(inp) -> compare.Stream``: the pairs in the order of the
    pipeline's input, with the headers step 1 reads and each pair's
    barcode id (-1 for none): the reference computes steps 1-3 and the
    per-bin reads from it;
  - ``step0_numbers(out_dir, ref) -> dict``: the platform's numbers of
    step 0 for one pass (``{}`` where the pass runs no step 0), each
    with a limit in the configuration's ``limits``;
  - for a ``driver`` traffic only, ``driver_argv(cfg, files) -> list``:
    the platform's own flags of ``driver.main``, with the paths from
    ``files`` (stLFR: ``-s stlfr -1 R1 -2 R2 -w whitelist``; a hybrid
    run ``-s short -1 R1 -2 R2 -l long_reads``, Tell-Seq ``-s tellseq
    ... -I index``). The harness appends ``-o -c -t -st 0
    --skip-external --device`` and then runs the pipeline on the
    barcode-sorted FASTQ step 0 leaves at ``compare.STEP0_SORTED``, so
    ``stream`` gives that file's pairs in its order and with its
    headers, worked out by the platform without the program (the
    reference's sort is ``reference.sort_order``; the stLFR rewrite is
    ``reference.stlfr_sorted``). ``compare.step0_records_off`` compares
    that file record by record; a ``step0_numbers`` that returns it
    under a name of its own needs a limit of that name. The seconds
    ``driver.main`` reports for step 0's sub-stages (``step0_s``) are
    read by ``metrics/step0.<stage>_s.py``; a sub-stage that no metric
    reads yet (hybrid: ``barcode_map``, ``short2long``, ``add_barcode``,
    ``assign``) gets a reader file of its own;
- ``metrics/<metric>.py``: a reader ``read(run)`` that returns the
  metric's value from a :class:`Run`, or None where it finds nothing to
  read, with its ``UNIT`` and the end-to-end metric it ``MOVES``. A
  metric moves one end-to-end metric, so where cells report different
  ones a quantity has a reader for each: ``<metric>.raw.py`` reads what
  ``<metric>.py`` reads (``read = sibling(__file__, "<metric>")``) in the
  cells that run step 0 from raw reads and report ``memory_peak_gb``.

The program is reached through its public entries only:
``pipeline.cli`` (the parser that turns the configuration into a
``PangaeaConfig``), ``pipeline.run.Pipeline`` and ``pipeline.driver.main``.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import compare, gen

HERE = os.path.dirname(os.path.abspath(__file__))
# the warm-up pass runs on this share of the barcodes, with every width of
# the cell's own pass
WARMUP_SHARE = 0.1


# ---- the manifest -----------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = gen.ROOT  # the checkout that holds its files


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its
    configuration and traffic files and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in man["end_to_end"] if _applies(m, name)],
                [m for m in man["per_layer"] if _applies(m, name)], root)


def _metric_module(path: str):
    name = os.path.basename(path)[:-len(".py")]
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, metric: dict) -> Callable:
    """``metrics/<name>.py``'s ``read``, checked against the manifest."""
    path = os.path.join(root, "benchmark", "metrics", metric["name"] + ".py")
    mod = _metric_module(path)
    if mod.UNIT != metric["unit"] or mod.MOVES != metric.get(
            "moves", metric["name"]):
        raise ValueError(f"{path}: UNIT/MOVES disagree with BENCHMARK.json")
    return mod.read


def sibling(path: str, name: str) -> Callable:
    """The ``read`` of ``metrics/<name>.py`` beside the reader at ``path``:
    for a metric that reads what ``name`` reads, in cells that report
    another end-to-end metric for it to move."""
    return _metric_module(os.path.join(os.path.dirname(path),
                                       name + ".py")).read


# ---- one pass ---------------------------------------------------------------

@dataclass
class Pass:
    """What one pass did and how long each part took."""

    seconds: float
    reads: int
    stages: Dict[str, float]
    step0_s: Dict[str, float]
    feature_stats: dict
    train: dict
    cluster: dict
    lloyd_iters: int
    skeleton_min: Optional[int]
    out_dir: str
    bytes_written: int = 0
    barcodes_kept: int = 0
    host_spans: List[tuple] = field(default_factory=list)

    def count_outputs(self) -> None:
        """Bytes the pass left on disk and barcodes in its latent."""
        self.bytes_written = _dir_bytes(self.out_dir)
        bcs = os.path.join(self.out_dir, "2.vae", "barcodes.npz")
        if os.path.isfile(bcs):
            self.barcodes_kept = len(np.load(bcs, allow_pickle=True)
                                     ["arr_0"])

    def work(self) -> dict:
        pt = self.train.get("phase_times", {})
        return {"reads": self.reads,
                "barcodes_kept": self.barcodes_kept,
                "train_units": pt.get("units"),
                "evals": len(self.train.get("val_history", [])),
                "k": self.cluster.get("k"),
                "lloyd_iters": self.lloyd_iters,
                "skeleton_min": self.skeleton_min,
                "bytes_written": self.bytes_written,
                "seconds": self.seconds,
                "step_s": dict(self.stages, step0=sum(self.step0_s.values()))}


def cli_args(config: dict, traffic: dict, out_dir: str, device: str
             ) -> List[str]:
    """The binning CLI's flags for the configuration's settings."""
    b = config["binning"]
    return ["-o", out_dir, "-k", str(b["k"]), "-tnf_k", str(b["tnf_k"]),
            "-s", str(b["s"]), "-v", str(b["v"]), "-l", str(b["l"]),
            "-r", str(b["lr"]), "-w", str(b["weight_decay"]),
            "-e", str(b["epochs"]), "-b", str(b["batch"]),
            "-d", str(b["dropout"]), "-p", str(b["patience"]),
            "-wa", str(b["weight_alpha"]), "-wk", str(b["weight_kl"]),
            "-ld", str(b["latent"]), "--matmul_dtype", b["matmul_dtype"],
            "-c", str(b["clusters"]), "-t", str(b["threads"]),
            "-st", traffic["steps"], "--device", device]


def pipeline_config(config: dict, traffic: dict, inputs: List[str],
                    out_dir: str, device: str):
    from pangaea_tpu_torch.pipeline import cli
    args = cli.build_parser().parse_args(
        inputs + cli_args(config, traffic, out_dir, device))
    cfg = cli.config_from_args(args)
    b = config["binning"]
    if (tuple(cfg.model.hidden_sizes) != tuple(b["hidden"])
            or cfg.model.seed != b["seed"]):
        raise ValueError("the CLI cannot set the configuration's hidden "
                         "sizes or seed")
    return cfg


class Step3Counts:
    """Counts the iterations of step 3's final Lloyd runs and the smallest
    skeleton RPH-KMeans reduced the latent to (it must hold ``-c``
    points), by wrapping what ``cluster/rph.py`` calls."""

    def __init__(self):
        from pangaea_tpu_torch.cluster import rph
        self.mod, self.iters, self.skeleton = rph, 0, None
        self.orig = rph.kmeans_lloyd, rph.RPHKMeans.init_centers
        lloyd, init = self.orig

        def counted(*a, **kw):
            out = lloyd(*a, **kw)
            self.iters += int(out[3])
            return out

        def sized(clt, X):
            out = init(clt, X)
            n = len(out[1])
            self.skeleton = n if self.skeleton is None else min(
                self.skeleton, n)
            return out
        rph.kmeans_lloyd, rph.RPHKMeans.init_centers = counted, sized

    def take(self):
        """(Lloyd iterations, smallest skeleton) since the last take."""
        out = self.iters, self.skeleton
        self.iters, self.skeleton = 0, None
        return out

    def close(self) -> None:
        self.mod.kmeans_lloyd, self.mod.RPHKMeans.init_centers = self.orig


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(dirpath, f))
    return total


def _span(spans: list, name: str, fn: Callable):
    def timed(*a, **kw):
        t0 = time.perf_counter_ns()
        try:
            return fn(*a, **kw)
        finally:
            spans.append((name, t0, time.perf_counter_ns()))
    return timed


def run_pass(cell: Cell, inp: gen.Inputs, out_dir: str, device: str,
             lloyd: Step3Counts) -> Pass:
    """One whole job on ``inp``'s files into the fresh ``out_dir``."""
    from pangaea_tpu_torch.pipeline.run import Pipeline
    spans: list = []
    t0 = time.perf_counter()
    step0: Dict[str, float] = {}
    entry = cell.traffic["entry"]
    if entry == "pipeline":
        inputs = ["-i", inp.files["interleaved"]]
    elif entry == "driver":
        from pangaea_tpu_torch.pipeline import driver
        root = logging.getLogger()
        handlers, level = list(root.handlers), root.level
        b = cell.config["binning"]
        t = time.perf_counter_ns()
        try:
            step0 = driver.main(
                inp.module.driver_argv(cell.config, inp.files)
                + ["-o", out_dir, "-c", str(b["clusters"]),
                   "-t", str(b["threads"]), "-st", "0", "--skip-external",
                   "--device", device])["step0_s"]
        finally:
            spans.append(("step0", t, time.perf_counter_ns()))
            for h in root.handlers[:]:
                if h not in handlers:
                    root.removeHandler(h)
                    h.close()
            root.setLevel(level)
        inputs = ["-i", os.path.join(out_dir, compare.STEP0_SORTED)]
    else:
        raise ValueError(f"unknown entry {entry!r}")
    pipe = Pipeline(pipeline_config(cell.config, cell.traffic, inputs,
                                     out_dir, device), device=device)
    for step in ("step1_features", "step2_train", "step3_cluster"):
        setattr(pipe, step, _span(spans, step.split("_")[0],
                                  getattr(pipe, step)))
    pipe.run()
    seconds = time.perf_counter() - t0
    fe = pipe.feature_extractor
    return Pass(seconds, inp.n_reads,
                {k: v.seconds for k, v in pipe.timer.stages.items()},
                dict(step0), dict(fe.stats) if fe is not None else {},
                dict(pipe.train_stats), dict(pipe.cluster_stats),
                *lloyd.take(), out_dir, host_spans=spans)


# ---- the traced window ------------------------------------------------------

class ScanLengths:
    """Records the length of every scan the window launches by wrapping
    the three public wrappers of ``kernels/scan.py``."""

    NAMES = ("cummax", "cummin_reverse", "cumsum")

    def __init__(self):
        from pangaea_tpu_torch.kernels import scan
        self.mod, self.lengths, self.orig = scan, [], {}
        for name in self.NAMES:
            fn = self.orig[name] = getattr(scan, name)
            setattr(scan, name, self._wrap(fn))

    def _wrap(self, fn):
        def recorded(x):
            out = fn(x)
            if x.device.type == "cuda":
                self.lengths.append(int(x.numel()))
            return out
        # the wrapped function counts its launches on the module's name
        recorded.launches = fn.launches
        return recorded

    def close(self) -> None:
        for name, fn in self.orig.items():
            fn.launches = getattr(self.mod, name).launches
            setattr(self.mod, name, fn)


@dataclass
class Trace:
    """The device's side of a traced window, from torch.profiler."""

    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_gaps: List[list]
    scan_lengths: List[int]


def _events(prof):
    """(name, start_ns, end_ns) of every device event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(s), int(s + d)))
    return out


def summarize(events, t0_host: int, t1_host: int, spans: List[tuple],
              scan_lengths: List[int]) -> Trace:
    """Busy time, time by kernel and idle gaps of a window. The first
    event is the marker launched at host time ``t0_host``; it maps the
    device clock onto the host clock."""
    events.sort(key=lambda e: e[1])
    offset = events[0][1] - t0_host
    by_name: Dict[str, float] = {}
    busy, gaps = 0, []
    cur_s = cur_e = None
    for name, s, e in events[1:]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(t_dev: int) -> str:
        t = t_dev - offset
        for name, s, e in spans:
            if s <= t <= e:
                return name
        return "harness"

    top = [[label((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:10]]
    return Trace((t1_host - t0_host) / 1e9, busy / 1e9, by_name, top,
                 list(scan_lengths))


# ---- the run ----------------------------------------------------------------

@dataclass
class Run:
    """Everything a metric reader reads."""

    cell: Cell
    setup_s: float
    window_s: float
    passes: List[Pass]
    trace: Optional[Trace]
    device_name: str
    peaks: dict
    # the card's peak allocated bytes over the window (0 off a card)
    memory_peak_bytes: int = 0

    @property
    def reads(self) -> int:
        return sum(p.reads for p in self.passes)

    def per_pass(self, get: Callable[[Pass], Optional[float]]
                 ) -> Optional[float]:
        """The mean over the passes of what ``get`` reads, or None where
        no pass has it."""
        vals = [v for v in map(get, self.passes) if v is not None]
        return sum(vals) / len(vals) if vals else None


def peaks(device_name: str) -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(device_name, {})


def run_window(cell: Cell, inp: gen.Inputs, work: str, seconds: float,
               device: str, lloyd: Step3Counts, traced: bool, t_start: float
               ) -> Run:
    """Whole passes until ``seconds`` have elapsed; the window ends with
    the pass running at that moment."""
    cuda = device == "cuda"
    prof = scans = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        scans = ScanLengths()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        torch.cuda.synchronize()
    t_win = time.perf_counter()
    t0_ns = time.perf_counter_ns()
    if traced:
        torch.ones(1, device=device).add_(1)  # the clock marker
        torch.cuda.synchronize()
    passes: List[Pass] = []
    try:
        while True:
            out = os.path.join(work, f"pass{len(passes)}")
            passes.append(run_pass(cell, inp, out, device, lloyd))
            if cuda:
                torch.cuda.synchronize()
            if time.perf_counter() - t_win >= seconds:
                break
        t_end = time.perf_counter()
        t1_ns = time.perf_counter_ns()
    finally:
        if scans is not None:
            scans.close()
        if prof is not None:
            prof.__exit__(None, None, None)
    trace = None
    if traced:
        spans = [s for p in passes for s in p.host_spans]
        trace = summarize(_events(prof), t0_ns, t1_ns, spans, scans.lengths)
    for p in passes:
        p.count_outputs()
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return Run(cell, t_win - t_start, t_end - t_win, passes, trace, name,
               peaks(name), peak)


def make_inputs(cell: Cell, seed: int, work: str):
    """The cell's inputs and its warm-up slice (``WARMUP_SHARE`` of the
    barcodes, the same geometry), written under ``work``."""
    inp = gen.simulate(cell.config, cell.traffic, seed, cell.root)
    gen.write(inp, cell.config, cell.traffic, work, "input")
    n_bc = len(inp.barcodes)
    keep = np.zeros(n_bc, bool)
    keep[:max(1, int(round(n_bc * WARMUP_SHARE)))] = 1
    warm = gen.subset(inp, keep)
    gen.write(warm, cell.config, cell.traffic, work, "warmup")
    return inp, warm


def check(run: Run, inp: gen.Inputs, device: str):
    """Each number of the comparison (its worst reading over the passes,
    beside its limit) and the count of passes with a number over it."""
    binning = run.cell.config["binning"]
    ref = compare.build_reference(inp, binning, device)
    per_pass = [compare.compare_pass(p.out_dir, ref, binning)
                for p in run.passes]
    limits = run.cell.config["limits"]
    failed = sum(any(not v <= limits[k] for k, v in nums.items())
                 for nums in per_pass)
    worst = compare.worst(per_pass)
    return {k: {"value": v, "limit": limits[k]}
            for k, v in worst.items()}, failed
