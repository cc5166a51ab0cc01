"""PyTorch port vs pangaea_tpu: step 4 as a whole, on the CPU.

pangaea_tpu's steps 1-3 run once on tests/test_pipeline.py's error-free
sim (``sim_clean``). Then step 4 of each package runs on its own copy of
that directory with every external tool reported missing, so the builtin
assembler, mapper, reassembly and circularizer run even where megahit is
installed. Every artifact must be byte-equal: the binned contigs, the
name-sorted BAM, the depth file, each low-abundance read file and
final_asm.fa, with and without circularization candidates. The port's own
steps 1-4 must also pass pangaea_tpu's assembly-volume gate
(tests/test_pipeline.py:104-107).
"""

import json
import os
import shutil

import pytest

from pangaea_tpu.asm.tools import ToolRunner as JaxRunner
from pangaea_tpu.config import AssemblyConfig as JaxAssembly
from pangaea_tpu.pipeline import Pipeline as JaxPipeline
from pangaea_tpu_torch.asm.fasta import iter_fasta
from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.config import AssemblyConfig
from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished
from pangaea_tpu_torch.pipeline.run import Pipeline as RunPipeline
from tests.test_pipeline import sim_clean, small_config  # noqa: F401
from tests.test_torch_pipeline import _port_config

ARTIFACTS = ("3.clustering/contigs.megahit.fa",
             "4.assembly/contigs.megahit.name_sorted.bam",
             "4.assembly/contigs.megahit.depth",
             "4.assembly/contigs.megahit_cut10.low_abd.fq",
             "4.assembly/contigs.megahit_cut30.low_abd.fq",
             "final_asm.fa")
CIRC_MIN = 3_000  # lowered circularize_min_size: the sim's contigs reach it


@pytest.fixture
def builtin_only(monkeypatch):
    for cls in (JaxRunner, ToolRunner):
        monkeypatch.setattr(cls, "available", lambda self, tool: False)


@pytest.fixture(scope="module")
def jax_steps_1_to_3(sim_clean, tmp_path_factory):  # noqa: F811
    reads, _ = sim_clean
    out = str(tmp_path_factory.mktemp("jax123") / "out")
    JaxPipeline(small_config(reads, out)).run()
    for step in ("1", "2", "3"):
        assert check_step_finished(out, step)
    return reads, out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("circularize", [False, True])
def test_step4_bytes_equal_jax(jax_steps_1_to_3, tmp_path, builtin_only,
                               circularize):
    reads, base = jax_steps_1_to_3
    outs = {}
    for tag in ("jax", "port"):
        outs[tag] = str(tmp_path / tag)
        shutil.copytree(base, outs[tag])
    jcfg = small_config(reads, outs["jax"], steps="4")
    pcfg = _port_config(reads, outs["port"]).replace(steps="4")
    if circularize:
        jcfg.assembly = JaxAssembly(circularize_min_size=CIRC_MIN,
                                    terminal_window=1_000)
        pcfg.assembly = AssemblyConfig(circularize_min_size=CIRC_MIN,
                                       terminal_window=1_000)
    JaxPipeline(jcfg).run()
    pipe = Pipeline(pcfg, device="cpu")
    pipe.run()
    assert check_step_finished(outs["port"], "4")
    for rel in ARTIFACTS:
        want = _bytes(os.path.join(outs["jax"], rel))
        assert want, rel
        assert _bytes(os.path.join(outs["port"], rel)) == want, rel
    merged = os.path.join(outs["port"], "4.assembly", "quickmerge",
                          "merged_out.fasta")
    min_size = pcfg.assembly.circularize_min_size
    n_candidates = sum(len(s) >= min_size for _, s in iter_fasta(merged))
    assert (n_candidates > 0) == circularize
    stats = pipe.assembly_stats
    assert set(stats["backend"].values()) <= {
        "builtin", "builtin (no flye),builtin (no nucmer)",
        "skipped (no -sp)", "skipped (no -at)"}
    assert stats["read_pairs"] > 0 and \
        0 < stats["mapped_bases"] <= stats["read_bases"]
    assert set(stats["low_abd_pairs"]) == {10, 30}


def test_port_steps_1_to_4_volume_gate(sim_clean, tmp_path,  # noqa: F811
                                       builtin_only, monkeypatch):
    """pangaea_tpu's gate: at least 4 contigs and more than 60,000 bases
    from 4 genomes of 30 kb; then a rerun skips every step."""
    reads, _ = sim_clean
    out = str(tmp_path / "out")
    cfg = _port_config(reads, out).replace(steps="1,2,3,4")
    pipe = Pipeline(cfg, device="cpu")
    pipe.run()
    for step in ("1", "2", "3", "4"):
        assert check_step_finished(out, step), step
    contigs = list(iter_fasta(os.path.join(out, "final_asm.fa")))
    assert len(contigs) >= 4
    total = sum(len(s) for _, s in contigs)
    assert total > 60_000, f"assembled only {total} bases"
    with open(os.path.join(out, "metrics.json")) as f:
        assert "step4_assemble" in json.load(f)
    for key in ("bins_s", "index_s", "mapback_s", "low_abd_s",
                "reassembly_s", "merge_s", "circularize_s"):
        assert pipe.assembly_stats[key] >= 0, key
    for step in ("step1_features", "step2_train", "step3_cluster",
                 "step4_assemble"):
        monkeypatch.setattr(RunPipeline, step, lambda *a, **k: pytest.fail(
            "a finished step ran again"))
    Pipeline(cfg, device="cpu").run()
