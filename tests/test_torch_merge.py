"""PyTorch port vs pangaea_tpu: the standalone final merge
(``pipeline.merge``), the profiler trace and the stage timer
(``profiling``), and the barcode-boundary FASTQ split
(``parallel.multihost.split_interleaved_by_barcode``).

The merge runs card-free (``device="cpu"``: the builtin containment
filter's mapper on the plain scans) on two copies of one run root, one
through each package; every file they write must be byte-equal, on both
layouts, with quickmerge (a fake that records its argv) and without it.
"""

import filecmp
import gzip
import json
import os

import pytest

from pangaea_tpu.asm.fasta import write_fasta
from pangaea_tpu.asm.tools import ToolRunner


class QMRunner(ToolRunner):
    """Only quickmerge's merge_wrapper.py exists (its output is faked and
    its argv recorded); merge_olc takes its builtin backends."""

    def __init__(self, with_quickmerge=True):
        super().__init__()
        self.commands = []
        self.with_quickmerge = with_quickmerge

    def available(self, tool):
        return self.with_quickmerge and tool == "merge_wrapper.py"

    def run(self, command, log_name=None, shell_cmd=None, cwd=None):
        self.commands.append(shell_cmd or " ".join(command))
        write_fasta(os.path.join(cwd, "merged_out.fasta"),
                    [("m1", "ACGT" * 100), ("m2", "GATTACA" * 50)])


def _merge_root(tmp_path, layout):
    """A run root with the artifacts final_merge.sh:19-41 expects, with
    contigs the builtin containment filter can map (seeded random
    sequence; one pool contig is a substring of the seed)."""
    import numpy as np
    rng = np.random.RandomState(11)

    def seq(n):
        return "".join("ACGT"[i] for i in rng.randint(0, 4, n))

    r = tmp_path / f"run_{layout}"
    if layout == "reference":
        pang, athena = r / "pangaea_out", r / "athena_out"
        sp, hy = r / "metaspades_out", r / "hybridspades_out"
        mp_fa = r / "metaplatanus_out" / "_result" / "out_final.fa"
    else:  # the driver's layout
        pang, athena = r, r / "2_athena_out"
        sp, hy = r / "1_metaspades_out", r / "3_hybridspades_out"
        mp_fa = r / "3_metaplatanus_out" / "out_final.fa"
    cl, asmd = pang / "3.clustering", pang / "4.assembly"
    olc = athena / "results" / "olc"
    for d in (cl, asmd, olc, sp, hy, mp_fa.parent, asmd / "cut10.spades",
              asmd / "cut5.megahit"):
        d.mkdir(parents=True, exist_ok=True)
    seed = seq(6000)
    write_fasta(str(cl / "contigs.megahit.fa"),
                [("bin1", seed[1000:3500]), ("bin2", seq(2500))])
    write_fasta(str(asmd / "cut10.spades" / "contigs.fasta"),
                [("sub1", seq(1800))])
    write_fasta(str(asmd / "cut5.megahit" / "final.contigs.fa"),
                [("sub2", seed[200:1400])])
    write_fasta(str(olc / "flye-input-contigs.fa"), [("loc1", seq(3000))])
    write_fasta(str(olc / "athena.asm.fa"), [("ath1", seq(900))])
    for d, name in ((sp / "contigs.fasta", "seedS"),
                    (hy / "contigs.fasta", "seedH"), (mp_fa, "seedM")):
        write_fasta(str(d), [(name, seed), (name + "b", seq(800))])
    return r


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


@pytest.mark.parametrize("quickmerge", [True, False])
@pytest.mark.parametrize("layout", ["reference", "driver"])
def test_final_merge_matches_jax(tmp_path, layout, quickmerge):
    """final_merge on two copies of one root: the same files, byte for
    byte; the same quickmerge argv (relpath of the olc result, realpath
    of athena, run from quickmerge_<type>/); the seed of the type asked
    for; the builtin containment filter ran (and dropped the contained
    pool contigs); a second run skips both stages."""
    from pangaea_tpu.pipeline.merge import final_merge as jax_merge
    from pangaea_tpu_torch.pipeline.merge import MergeLayout, final_merge
    jroot = _merge_root(tmp_path / "jax", layout)
    troot = _merge_root(tmp_path / "torch", layout)
    jrun, trun = QMRunner(quickmerge), QMRunner(quickmerge)
    jout = jax_merge(str(jroot), "hybridspades", runner=jrun)
    stats = {}
    tout = final_merge(str(troot), "hybridspades", runner=trun,
                       device="cpu", stats=stats)
    assert os.path.relpath(tout, troot) == os.path.relpath(jout, jroot)
    assert stats["backend"]["containment"] == "builtin"
    jt, tt = _tree(jroot), _tree(troot)
    assert sorted(jt) == sorted(tt)
    for rel in jt:
        assert filecmp.cmp(jt[rel], tt[rel], shallow=False), rel
    lay = MergeLayout(str(troot))
    qm_dir = os.path.join(lay.assembly_dir, "quickmerge_hybridspades")
    olc_final = os.path.join(lay.assembly_dir, "olc_hybridspades",
                             "final.asm.fa")
    if quickmerge:
        assert trun.commands == [
            "merge_wrapper.py " + os.path.relpath(olc_final, qm_dir) + " "
            + os.path.realpath(lay.athena)]
        assert [c.replace(str(jroot), str(troot)) for c in jrun.commands] \
            == trun.commands
    else:
        assert trun.commands == []
    filt = open(os.path.join(lay.assembly_dir, "olc_hybridspades",
                             "pre-flye-input-contigs.filt.fa")).read()
    pool = open(os.path.join(lay.assembly_dir,
                             "contigs.low_abd.binning.local.fa")).read()
    assert filt.count(">") < pool.count(">")   # contained contigs dropped
    # resume: both stages skip on existing outputs
    again = QMRunner(quickmerge)
    final_merge(str(troot), "hybridspades", runner=again, device="cpu")
    assert again.commands == []
    assert not [f for f in os.listdir(qm_dir) if f.endswith(".tmp")]


def test_final_merge_rejects_unknown_type(tmp_path):
    from pangaea_tpu_torch.pipeline.merge import final_merge
    root = _merge_root(tmp_path, "reference")
    with pytest.raises(ValueError, match="operams"):
        final_merge(str(root), "operams", device="cpu")
    os.remove(os.path.join(str(root), "athena_out", "results", "olc",
                           "athena.asm.fa"))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        final_merge(str(root), "metaspades", device="cpu")


def test_merge_entry_point(tmp_path, capsys):
    """``python -m pangaea_tpu_torch.pipeline.merge <path> <type>
    --device cpu`` prints the final assembly's path."""
    from pangaea_tpu_torch.pipeline import merge
    root = _merge_root(tmp_path, "driver")
    merge.main([str(root), "metaspades", "--device", "cpu", "-t", "1"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.endswith(os.path.join("quickmerge_metaspades",
                                     "merged_out.fasta"))
    assert os.path.isfile(out)


# ---- profiling -----------------------------------------------------------------


def test_stage_timer(tmp_path):
    from pangaea_tpu_torch.profiling import StageTimer
    t = StageTimer()
    with t.stage("read", unit="reads") as st:
        st.items += 100
    t.add("read", 20)
    t.add("write", 5, unit="records")
    assert t.stages["read"].items == 120
    assert t.stages["write"].unit == "records"
    assert t.stages["read"].seconds >= 0
    t.dump(str(tmp_path / "m.json"))
    m = json.load(open(tmp_path / "m.json"))
    assert m["read"]["items"] == 120 and m["write"]["items"] == 5


def test_trace_writes_a_chrome_trace_only_when_asked(tmp_path, monkeypatch):
    """With a trace_dir (or PANGAEA_TPU_TRACE) the block's CPU ops and
    annotate's ranges land in a Chrome trace; unset, nothing is
    written."""
    import torch
    from pangaea_tpu_torch.profiling import TRACE_ENV, annotate, trace
    monkeypatch.delenv(TRACE_ENV, raising=False)
    quiet = tmp_path / "quiet"
    with trace("pipeline"):
        torch.ones(8).cumsum(0)
    assert not quiet.exists()
    d = tmp_path / "trace"
    with trace("pipeline", trace_dir=str(d)):
        with annotate("step1"):
            torch.arange(1000).cumsum(0)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.load(open(d / files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"pipeline", "step1"} <= names
    assert any("cumsum" in str(n) for n in names)
    monkeypatch.setenv(TRACE_ENV, str(tmp_path / "env"))
    with trace("pipeline"):
        torch.ones(4).sum()
    assert len(os.listdir(tmp_path / "env")) == 1


def test_pipeline_run_is_traced(tmp_path, monkeypatch):
    """Pipeline.run wraps its steps in trace('pipeline'): with
    PANGAEA_TPU_TRACE set, a run (here one with every step skipped)
    leaves one trace file."""
    from pangaea_tpu_torch.config import PangaeaConfig
    from pangaea_tpu_torch.pipeline import Pipeline
    monkeypatch.setenv("PANGAEA_TPU_TRACE", str(tmp_path / "t"))
    os.makedirs(tmp_path / "out")
    Pipeline(PangaeaConfig(output=str(tmp_path / "out"), steps="none"),
             device="cpu").run()
    assert len(os.listdir(tmp_path / "t")) == 1


# ---- the barcode-boundary split ---------------------------------------------------


@pytest.mark.parametrize("gz", [False, True])
def test_split_interleaved_by_barcode_matches_jax(tmp_path, gz):
    """Plain and gzip input (4 KiB chunks on gzip, so boundaries fall
    mid-chunk): the port's shards hold pangaea_tpu's records, no barcode
    spans two shards, every record is kept."""
    from pangaea_tpu.io.sim import simulate_linked_reads
    from pangaea_tpu.parallel.multihost import (
        split_interleaved_by_barcode as jax_split)
    from pangaea_tpu_torch.io.fastq import iter_fastq_records
    from pangaea_tpu_torch.parallel.multihost import (
        split_interleaved_by_barcode)
    reads = str(tmp_path / ("r.fq.gz" if gz else "r.fq"))
    nb, ppb = (64, 12) if gz else (60, 10)
    simulate_linked_reads(out_interleaved=reads, n_species=2,
                          genome_len=10_000, n_barcodes=nb,
                          pairs_per_barcode=ppb, seed=5 if gz else 3)
    kw = {"chunk_size": 4096} if gz else {}
    shards = split_interleaved_by_barcode(reads, str(tmp_path / "t"), 4,
                                          **kw)
    want = jax_split(reads, str(tmp_path / "j"), 4, **kw)
    assert all(s.endswith(".fq.gz" if gz else ".fq") for s in shards)
    opener = gzip.open if gz else open
    for a, b in zip(shards, want):
        with opener(a, "rb") as fa, opener(b, "rb") as fb:
            assert fa.read() == fb.read()
    seen, total = {}, 0
    for i, sh in enumerate(shards):
        for rec in iter_fastq_records(sh):
            total += 1
            bc = rec.header.split("BX:Z:")[1].split("-")[0]
            assert seen.setdefault(bc, i) == i
    assert total == nb * ppb * 2
