"""The harness drives a whole run on the CPU at a tiny size, a cell added
from data files alone included, and its comparison fails on planted
faults."""

import json
import os

import numpy as np
import pytest

import tiny


def test_a_cell_from_data_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    with open(os.path.join(root, "benchmark", "traffic", "bin.json")) as f:
        tr = json.load(f)
    tr["pairs_per_barcode"] = 12
    with open(os.path.join(root, "benchmark", "traffic", "deep.json"),
              "w") as f:
        json.dump(tr, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["workloads"].append({"name": "10x-atcc.deep", "config": "10x-atcc",
                             "traffic": "deep", "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    rc, res, out, err = tiny.run_cell(root, "10x-atcc.deep")
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
