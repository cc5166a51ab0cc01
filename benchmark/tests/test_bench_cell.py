"""The harness drives a whole run on the CPU at a tiny size, a cell added
from data files alone and a platform added from files alone included,
and its comparison fails on planted faults."""

import hashlib
import json
import os

import numpy as np
import pytest

import tiny
from benchmark import harness


def test_a_cell_from_data_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    with open(os.path.join(root, "benchmark", "traffic", "bin.json")) as f:
        tr = json.load(f)
    tr["pairs_per_barcode"] = 12
    with open(os.path.join(root, "benchmark", "traffic", "deeper.json"),
              "w") as f:
        json.dump(tr, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["workloads"].append({"name": "10x-atcc.deeper", "config": "10x-atcc",
                             "traffic": "deeper", "chips": 1, "why": "test"})
    # the new cell joins the metrics of the cell it is like: entries of
    # BENCHMARK.json, no file changed
    for m in man["end_to_end"] + man["per_layer"]:
        if "10x-atcc.bin" in m.get("workloads", []):
            m["workloads"].append("10x-atcc.deeper")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    rc, res, out, err = tiny.run_cell(root, "10x-atcc.deeper")
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["failed"] == 0, res
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    work = json.loads(out.strip().splitlines()[-2])["work"]
    assert work[0]["reads"] == 160 * 12 * 2 and work[0]["k"] == 4
    assert list(res)[-1] == "compared"
    assert err.strip().splitlines()[-1].startswith("compared ")


FAULTS = ["adam_noop", "half_batch", "label", "fewer_clusters",
          "kmer_count", "record"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_are_not_correct(tmp_path, monkeypatch, fault):
    """The timed path broken underneath: a step that leaves its state
    unchanged, half of each batch left out (the mean over the rest), and
    an answer altered where it is produced (a cluster label, one k-mer
    count of step 1, one record of step 0's sort), and a step 3 that
    clusters into one cluster fewer than ``-c`` asks for."""
    from pangaea_tpu_torch import cluster
    from pangaea_tpu_torch.features import FeatureExtractor
    from pangaea_tpu_torch.model.train import VAETrainer
    from pangaea_tpu_torch.pipeline import driver

    cell = "10x-atcc.bin"
    if fault == "adam_noop":
        make = VAETrainer.optimizer

        def frozen(self):
            opt = make(self)
            opt.step = lambda closure=None: None
            return opt
        monkeypatch.setattr(VAETrainer, "optimizer", frozen)
    elif fault == "half_batch":
        orig = VAETrainer._losses

        def half(self, gen, abd, tnf, rows, *a, **kw):
            return orig(self, gen, abd, tnf, rows[:max(1, len(rows) // 2)],
                        *a, **kw)
        monkeypatch.setattr(VAETrainer, "_losses", half)
    elif fault == "label":
        orig = cluster.clustering_rph_kmeans

        def moved(emb, k, **kw):
            lab = np.array(orig(emb, k, **kw))
            lab[0] = (lab[0] + 1) % k
            return lab
        monkeypatch.setattr(cluster, "clustering_rph_kmeans", moved)
    elif fault == "fewer_clusters":
        orig = cluster.clustering_rph_kmeans

        def fewer(emb, k, **kw):
            return orig(emb, k - 1, **kw)
        monkeypatch.setattr(cluster, "clustering_rph_kmeans", fewer)
    elif fault == "kmer_count":
        orig = FeatureExtractor._write_csv_gz

        def bumped(path, names, mat):
            if "abundance" in os.path.basename(path):
                mat = mat.copy()
                mat[0, 0] += 1
            orig(path, names, mat)
        monkeypatch.setattr(FeatureExtractor, "_write_csv_gz",
                            staticmethod(bumped))
    else:
        cell = "stlfr-atcc.raw"
        orig = driver.barcode_sort_interleaved

        def swapped(src, dst, *a, **kw):
            orig(src, dst, *a, **kw)
            with open(dst, "rb") as f:
                lines = f.read().split(b"\n")
            lines[1] = lines[1][::-1]
            with open(dst, "wb") as f:
                f.write(b"\n".join(lines))
        monkeypatch.setattr(driver, "barcode_sort_interleaved", swapped)
    rc, res, out, err = tiny.run_cell(tiny.make_root(tmp_path), cell)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False and res["failed"] == res["attempted"]


# A platform the harness does not know: 10x reads as raw R1 and R2 gzip
# files with their BX:Z tags, in the sequencer's order, so that a pass runs
# the driver's step 0 (interleave and barcode sort) before steps 1-3.
TOY_PLATFORM = '''
import os

import numpy as np

from benchmark import compare, gen, reference


def simulate(cfg, traffic, seed):
    rng = np.random.default_rng(seed)
    pair_bc, s1, s2, q1, q2, strain = gen.pairs(cfg, traffic, rng, True)
    n = len(pair_bc)
    words = gen._distinct_words(rng, int(traffic["barcodes"]),
                                int(cfg["barcode_len"]))
    order = rng.permutation(n)
    names = np.char.add(b"t", np.char.zfill(np.arange(n).astype("S"), 7))
    return gen.Inputs({}, n, int(cfg["read_len"]), s1[order], s2[order],
                      q1[order], q2[order], names, pair_bc[order], words,
                      strain[order], cfg["platform"])


def _headers(inp):
    bx = np.char.add(b"\\tBX:Z:", inp.barcodes[inp.pair_barcode])
    return np.char.add(np.char.add(np.char.add(b"@", inp.names), bx), b"-1")


def write(inp, cfg, traffic, out_dir, prefix):
    files, h = {}, _headers(inp)
    for mate, s, q in ((1, inp.seq1, inp.qual1), (2, inp.seq2, inp.qual2)):
        path = os.path.join(out_dir, f"{prefix}.R{mate}.fq.gz")
        gen.write_gzip(path, gen.pack_records([h], [s], [q]),
                       int(cfg["gzip_level"]))
        files[f"r{mate}"] = path
    return files


def subset(inp, keep_barcodes):
    return gen.take(inp, keep_barcodes[inp.pair_barcode])


def driver_argv(cfg, files):
    return ["-s", "10x", "-1", files["r1"], "-2", files["r2"]]


def stream(inp):
    keys = np.char.add(np.char.add(b"BX:Z:", inp.barcodes[inp.pair_barcode]),
                       b"-1")
    order = reference.sort_order(keys, inp.names)
    return compare.Stream(inp.seq1[order], inp.seq2[order], inp.qual1[order],
                          inp.qual2[order], _headers(inp)[order],
                          inp.pair_barcode[order], inp.barcodes)


def step0_numbers(out_dir, ref):
    return {"toy_sorted_off": compare.step0_records_off(out_dir, ref)}
'''


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_a_platform_from_files_alone(tmp_path):
    """A new input kind with a driver entry and a step 0 number of its
    own joins the benchmark through new files and new manifest entries:
    its platform module, configuration and traffic. No file the root
    already holds changes, and the harness is the repository's."""
    root = tiny.make_root(tmp_path)
    before = _digests(root)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "platforms", "tenx_raw.py"), "w") as f:
        f.write(TOY_PLATFORM)
    with open(os.path.join(bench, "configs", "10x-atcc.json")) as f:
        cfg = json.load(f)
    cfg.update(name="toy-atcc", platform="tenx_raw")
    cfg["limits"]["toy_sorted_off"] = 0
    with open(os.path.join(bench, "configs", "toy-atcc.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "toyraw.json"), "w") as f:
        json.dump({"entry": "driver", "steps": "1,2,3", "barcodes": 160,
                   "pairs_per_barcode": 10}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "toy-atcc", "source": "test",
                           "file": "benchmark/configs/toy-atcc.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "toy-atcc.raw", "config": "toy-atcc",
                             "traffic": "toyraw", "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)

    cell = harness.load_cell(root, "toy-atcc.raw")
    work = str(tmp_path / "work")
    inp, warm = harness.make_inputs(cell, 2 ** 31 + 3, work)
    assert set(inp.files) == {"r1", "r2"} and warm.n_pairs == 16 * 10
    lloyd = harness.Step3Counts()
    try:
        p = harness.run_pass(cell, inp, os.path.join(work, "pass0"), "cpu",
                             lloyd)
    finally:
        lloyd.close()
    assert p.reads == 160 * 10 * 2
    assert {"interleave_s", "sort_s"} <= set(p.step0_s)
    run = harness.Run(cell, 1.0, p.seconds, [p], None, "cpu", {})
    compared, failed = harness.check(run, inp, "cpu")
    assert failed == 0, compared
    assert list(compared)[0] == "toy_sorted_off"
    assert set(compared) == set(cfg["limits"])
    assert all(c["value"] <= c["limit"] for c in compared.values())
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == dict(
        before, **{"BENCHMARK.json": after["BENCHMARK.json"]})
    added = set(after) - set(before)
    assert added == {os.path.join("benchmark", *p) for p in (
        ("platforms", "tenx_raw.py"), ("configs", "toy-atcc.json"),
        ("traffic", "toyraw.json"))}
