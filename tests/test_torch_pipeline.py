"""PyTorch port end to end: steps 1-3 on the tests/test_pipeline.py sim.

The port's Pipeline(device="cpu") must bin the simulated 4-species reads
as well as pangaea_tpu does (ARI vs truth > 0.95, the JAX package's gate),
agree with pangaea_tpu's own clusters.tsv on the same input (cross-ARI
>= 0.95), honour the resume markers, and the package must load neither
JAX, nor pangaea_tpu, nor scikit-learn.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from pangaea_tpu.pipeline import Pipeline as JaxPipeline
from pangaea_tpu_torch.cluster.metrics import adjusted_rand_score
from pangaea_tpu_torch.config import (ClusterConfig, FeatureConfig,
                                      ModelConfig, PangaeaConfig)
from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished
from pangaea_tpu_torch.pipeline import cli
from pangaea_tpu_torch.pipeline.run import Pipeline as RunPipeline
from tests.test_pipeline import sim, small_config  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_config(reads, out):
    j = small_config(reads, out)
    return PangaeaConfig(
        interleaved_reads=reads, output=out, steps=j.steps,
        feature=FeatureConfig(reads_per_batch=j.feature.reads_per_batch),
        model=ModelConfig(epochs=j.model.epochs,
                          batch_size=j.model.batch_size,
                          patience=j.model.patience,
                          eval_every_batches=j.model.eval_every_batches),
        cluster=ClusterConfig(n_clusters=j.cluster.n_clusters,
                              n_init=j.cluster.n_init))


def _clusters(out):
    cluster_of = {}
    with open(os.path.join(out, "3.clustering", "clusters.tsv")) as f:
        for line in f:
            cid, bcs = line.rstrip("\n").split("\t")
            for bc in bcs.split(","):
                cluster_of[bc] = int(cid)
    return cluster_of


@pytest.fixture(scope="module")
def port_run(sim, tmp_path_factory):  # noqa: F811
    reads, res = sim
    out = str(tmp_path_factory.mktemp("torch_pipe") / "out")
    Pipeline(_port_config(reads, out), device="cpu").run()
    return out, res


def test_port_steps_1_to_3(port_run):
    out, res = port_run
    for step in ("1", "2", "3"):
        assert check_step_finished(out, step), f"step {step} not finished"
    cluster_of = _clusters(out)
    labelled = [bc for bc in cluster_of if bc in res.barcode_species]
    assert len(labelled) > 100
    ari = adjusted_rand_score([res.barcode_species[bc] for bc in labelled],
                              [cluster_of[bc] for bc in labelled])
    assert ari > 0.95, f"ARI {ari}"
    bins = [f for f in os.listdir(os.path.join(out, "3.clustering"))
            if f.endswith(".fq")]
    assert len(bins) == 4
    with open(os.path.join(out, "metrics.json")) as f:
        stages = json.load(f)
    assert {"step1_features", "step2_train", "step3_cluster"} <= set(stages)


def test_port_rerun_skips_every_step(port_run, sim, monkeypatch):  # noqa: F811
    out, _ = port_run
    for step in ("step1_features", "step2_train", "step3_cluster"):
        monkeypatch.setattr(RunPipeline, step, lambda *a, **k: pytest.fail(
            "a finished step ran again"))
    Pipeline(_port_config(sim[0], out), device="cpu").run()


def test_port_agrees_with_jax_pipeline(port_run, sim, tmp_path):  # noqa: F811
    reads, _ = sim
    out, _ = port_run
    jout = str(tmp_path / "jax")
    JaxPipeline(small_config(reads, jout)).run()
    mine, theirs = _clusters(out), _clusters(jout)
    assert set(mine) == set(theirs)
    common = sorted(mine)
    cross = adjusted_rand_score([mine[b] for b in common],
                                [theirs[b] for b in common])
    assert cross >= 0.95, f"cross-ARI {cross}"


def test_step3_writes_clusters_through_unique_temp(port_run, sim,  # noqa: F811
                                                   tmp_path):
    """pangaea_tpu writes clusters.tsv through the fixed name
    'clusters.tsv.tmp'; the port's temp name is unique, so a stale or
    concurrent one cannot clash. Step 3 rerun from step 2's artifacts
    gives the same clusters and leaves no temp file of its own."""
    out, _ = port_run
    rerun = str(tmp_path / "out")
    shutil.copytree(os.path.join(out, "2.vae"), os.path.join(rerun, "2.vae"))
    taken = os.path.join(rerun, "3.clustering", "clusters.tsv.tmp")
    os.makedirs(taken)
    cfg = _port_config(sim[0], rerun).replace(steps="3")
    Pipeline(cfg, device="cpu").run()
    assert check_step_finished(rerun, "3")
    assert _clusters(rerun) == _clusters(out)
    assert [f for f in os.listdir(os.path.dirname(taken))
            if f.endswith(".tmp")] == ["clusters.tsv.tmp"]


def test_unported_requests_raise(tmp_path, sim):  # noqa: F811
    """k = 32 is past the reference's uint64 k-mers: step 1 raises and
    leaves no marker. bfloat16 VAE matmuls are not ported: step 2
    raises and leaves no marker."""
    reads, _ = sim
    cfg = _port_config(reads, str(tmp_path / "k")).replace(steps="1")
    cfg.feature.kmer = 32
    with pytest.raises(ValueError, match="1..31"):
        Pipeline(cfg, device="cpu").run()
    assert not check_step_finished(cfg.output, "1")
    cfg = _port_config(reads, str(tmp_path / "b")).replace(steps="1,2")
    cfg.model.matmul_dtype = "bfloat16"
    with pytest.raises(NotImplementedError):
        Pipeline(cfg, device="cpu").run()
    assert not check_step_finished(cfg.output, "2")


def test_default_device_is_the_card():
    """Built without a device, an entry point asks for CUDA and raises
    where there is none: the port never falls back on its own."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline(PangaeaConfig())


@pytest.mark.parametrize("argv", [
    ["-c", "4", "--matmul_dtype", "bfloat16"],
    ["-c", "4", "--cluster_device_min_elems", "10"],
    ["-m", "db", "--matmul_dtype", "bfloat16"],   # -m and no -c parse
    ["--cluster_device_min_elems", "10"],
])
def test_cli_rejects_unported_flags(argv, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["-i", "x.fq", "-o", str(tmp_path / "o"), *argv])
    assert e.value.code == 2


def test_cli_builds_config():
    p = cli.build_parser()
    args = p.parse_args(["-i", "r.fq", "-o", "o", "-c", "7", "-e", "3",
                         "-k", "13", "--device", "cpu"])
    cli.check_supported(p, args)
    cfg = cli.config_from_args(args)
    assert (cfg.cluster.n_clusters, cfg.model.epochs, cfg.feature.kmer) == \
        (7, 3, 13)
    assert args.device == "cpu"
    # paired input and the spill flags are honoured
    args = p.parse_args(["-1", "a.fq", "-2", "b.fq", "-o", "o", "-c", "4",
                         "--spill_store", "disk", "--spill_dir", "sp"])
    cli.check_supported(p, args)
    cfg = cli.config_from_args(args)
    assert (cfg.reads1, cfg.reads2, cfg.interleaved_reads) == \
        ("a.fq", "b.fq", "")
    assert (cfg.feature.spill_store, cfg.feature.spill_dir) == ("disk", "sp")


def test_cli_honours_step4_flags():
    """The default steps are pangaea_tpu's 1,2,3,4, and the step-4 inputs
    reach the config."""
    p = cli.build_parser()
    args = p.parse_args(["-i", "r.fq", "-o", "o", "-c", "4"])
    cli.check_supported(p, args)
    assert cli.config_from_args(args).steps == "1,2,3,4"
    args = p.parse_args(["-i", "r.fq", "-o", "o", "-c", "4", "-sp", "s.fa",
                         "-lc", "l.fa", "-at", "a.fa", "-lt", "5,20",
                         "-la", "spades", "-st", "4"])
    cli.check_supported(p, args)
    cfg = cli.config_from_args(args)
    assert (cfg.spades, cfg.local_assembly, cfg.athena, cfg.steps) == \
        ("s.fa", "l.fa", "a.fa", "4")
    assert (cfg.assembly.low_abd_cut, cfg.assembly.low_assembler) == \
        ("5,20", "spades")


def test_port_imports_no_jax_and_no_pangaea_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pangaea_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pangaea_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('native', 'io.fast_packing', 'features', 'io.bam',\n"
        "          'asm.tools', 'asm.fasta', 'asm.naive', 'asm.unmapped',\n"
        "          'asm.mapper', 'asm.bin_assembly', 'asm.merge_olc',\n"
        "          'asm.circular_logic', 'asm.circularize', 'asm.final',\n"
        "          'asm.diversity', 'cluster.k_selection', 'pipeline.run'):\n"
        "    assert 'pangaea_tpu_torch.' + m in sys.modules, m\n"
        "from pangaea_tpu_torch.pipeline.run import Pipeline\n"
        "from pangaea_tpu_torch.cluster import select_k_with_bic\n"
        "assert callable(Pipeline._estimate_k)\n"
        "assert callable(select_k_with_bic)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'pangaea_tpu', 'sklearn')]\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('pangaea_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) > 25
