"""PyTorch port vs pangaea_tpu: step 0 and the driver, byte for byte.

The port copies pangaea_tpu's step-0 host code (io/preprocess.py, the
barcode sort of io/fastq.py with its native, GNU and Python back ends,
io/hybrid.py, utils.GlibcRand, io/sim.simulate_stlfr_raw) and its driver
(pipeline/driver.py). Each is fed the same input as pangaea_tpu's and must
write the same bytes. The driver runs on ``device="cpu"``: the stLFR
whitelist path through step 1 (the sorted FASTQ and the feature CSVs) and
hybrid ``preprocess_reads`` with the builtin k-mer vote mapper (the
sorted FASTQ, the short-to-long BAM and the barcode map).
"""

import argparse
import gzip
import logging
import os
import random
import shutil

import pytest

import pangaea_tpu.utils as jutils
from pangaea_tpu.asm.tools import ToolRunner as JaxToolRunner
from pangaea_tpu.io import fastq as jfastq
from pangaea_tpu.io import hybrid as jhybrid
from pangaea_tpu.io import preprocess as jpre
from pangaea_tpu.io import sim as jsim
from pangaea_tpu.io.bam import BamRecord, BamWriter, FPAIRED, FREAD1, FUNMAP
from pangaea_tpu.pipeline import driver as jdriver
from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.io import fastq as tfastq
from pangaea_tpu_torch.io import hybrid as thybrid
from pangaea_tpu_torch.io import preprocess as tpre
from pangaea_tpu_torch.io import sim as tsim
from pangaea_tpu_torch.pipeline import driver as tdriver
from pangaea_tpu_torch.utils import GlibcRand
from tests.test_hybrid_e2e import make_hybrid_data


def _read(path) -> bytes:
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _same_files(a_dir, b_dir, names):
    for name in names:
        assert _read(os.path.join(a_dir, name)) == \
            _read(os.path.join(b_dir, name)), name


@pytest.fixture
def root_logging():
    """The drivers add handlers to the root logger; take them off again."""
    root = logging.getLogger()
    before = list(root.handlers)
    yield
    for h in root.handlers[:]:
        if h not in before:
            root.removeHandler(h)
            h.close()


# ---- the stLFR simulator and preprocessing ---------------------------------

STLFR = dict(n_species=2, genome_len=6_000, n_partitions=60,
             pairs_per_partition=6, read_len=80, insert_len=200, n_wl=24,
             unassigned_frac=0.1, index_error_rate=0.1, error_rate=0.01,
             seed=5)


def _stlfr(d, pkg):
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, f) for f in ("r1.fq", "r2.fq", "wl.txt")]
    res = pkg.simulate_stlfr_raw(*paths, **STLFR)
    return paths, res


def test_simulate_stlfr_raw_equals_jax(tmp_path):
    tp, tres = _stlfr(tmp_path / "t", tsim)
    jp, jres = _stlfr(tmp_path / "j", jsim)
    for a, b in zip(tp, jp):
        assert _read(a) == _read(b)
    assert vars(tres) == vars(jres)
    assert tres.n_unassigned > 0 and tres.n_index_errors > 0


def _quirk_pairs(d):
    """Hand-made stLFR headers around the bc3 quirk
    (preprocess_stlfr.cpp:91): x_y_0 keeps its barcode, 0_y_z and x_0_z
    lose theirs, 0_0_0 is unbarcoded; a header without '/'; gzipped."""
    r1, r2 = os.path.join(d, "q1.fq.gz"), os.path.join(d, "q2.fq.gz")
    heads = ["a#3_4_5/1", "b#1_2_0/1", "c#0_2_3/1", "d#4_0_1/1",
             "e#0_0_0/1", "f#2_2_2"]
    with gzip.open(r1, "wt") as f1, gzip.open(r2, "wt") as f2:
        for i, h in enumerate(heads):
            seq = "ACGT"[i % 4] * 8
            f1.write(f"@{h}\n{seq}\n+\n{'I' * 8}\n")
            f2.write(f"@{h[:-1]}2\n{seq[::-1]}\n+\n{'5' * 8}\n")
    return r1, r2


@pytest.mark.parametrize("whitelist", [False, True])
def test_preprocess_stlfr_equals_jax(tmp_path, whitelist):
    (r1, r2, wl_path), _ = _stlfr(tmp_path, tsim)
    q1, q2 = _quirk_pairs(str(tmp_path))
    for tag, (a, b) in (("sim", (r1, r2)), ("quirk", (q1, q2))):
        outs = {}
        for name, pkg in (("t", tpre), ("j", jpre)):
            wl = pkg.load_whitelist(wl_path) if whitelist else None
            outs[name] = pkg.preprocess_stlfr(
                a, b, str(tmp_path / f"{name}_{tag}"), numeric=not whitelist,
                library=True, whitelist=wl)
        for x, y in zip(outs["t"], outs["j"]):
            assert _read(x) == _read(y)
    text = _read(str(tmp_path / "t_quirk_1.fq")).decode()
    if not whitelist:
        assert "@b\tBX:Z:1_2_0-1\n" in text and "@c\n" in text


def _tellseq(d):
    """R1/R2 with headers carrying comments, and an index FASTQ of 18-bp
    barcodes with some of the wrong length (dropped with a warning)."""
    rng = random.Random(4)
    paths = [os.path.join(d, f) for f in ("t1.fq.gz", "t2.fq.gz",
                                          "i1.fq.gz")]
    with gzip.open(paths[0], "wt") as f1, gzip.open(paths[1], "wt") as f2, \
            gzip.open(paths[2], "wt") as fi:
        for i in range(60):
            bc = "".join(rng.choice("ACGT") for _ in range(
                17 if i % 9 == 4 else 18))
            s1 = "".join(rng.choice("ACGT") for _ in range(30))
            s2 = "".join(rng.choice("ACGT") for _ in range(30))
            f1.write(f"@rd{i} 1:N:0\n{s1}\n+\n{'F' * 30}\n")
            f2.write(f"@rd{i} 2:N:0\n{s2}\n+\n{':' * 30}\n")
            fi.write(f"@rd{i} 1:N:0\n{bc}\n+\n{'F' * len(bc)}\n")
    return paths


def test_preprocess_tellseq_and_interleave_equal_jax(tmp_path):
    r1, r2, i1 = _tellseq(str(tmp_path))
    for name, pkg in (("t", tpre), ("j", jpre)):
        a, b = pkg.preprocess_tellseq(r1, r2, i1, str(tmp_path / name))
        pkg.interleave(a, b, str(tmp_path / f"{name}_inter.fq"))
        pkg.interleave(r1, r2, str(tmp_path / f"{name}_gz_inter.fq"))
    for suffix in ("_1.fq", "_2.fq", ".wl", "_inter.fq", "_gz_inter.fq"):
        assert _read(tmp_path / f"t{suffix}") == _read(tmp_path / f"j{suffix}")
    assert _read(tmp_path / "t.wl").count(b"\n") == 53   # 7 of 60 dropped


# ---- the barcode sort ------------------------------------------------------

def _sort_input(d, case):
    """Interleaved records: barcoded (10x tags, stLFR-style tags after a
    tab), unbarcoded, and the case's twist."""
    rng = random.Random(sum(map(ord, case)))
    bcs = ["TTGA", "AACG", "GGAT", "CCAA", "ACGT-2", ""]
    recs = []
    for i in range(120):
        bc = bcs[rng.randrange(len(bcs))]
        seq = "".join(rng.choice("ACGTN") for _ in range(rng.randint(5, 40)))
        sep = "\t" if i % 3 else " "
        head = f"r{i}{sep}BX:Z:{bc}-1" if bc else f"r{i} comment"
        for mate in (1, 2):
            recs.append(f"@{head}\n{seq}\n+\n{'I' * len(seq)}\n")
    text = "".join(recs)
    path = os.path.join(d, "in.fq")
    if case == "no_trailing_newline":
        text = text[:-1]
    elif case == "partial_last_record":
        text += "@r999\tBX:Z:AACG-1\nACGT\n+\nIIII\n@r999\tBX:Z:AACG-1\n"
    if case == "gz_input":
        path += ".gz"
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return path


@pytest.mark.parametrize("backend", ["native", "gnu", "python"])
@pytest.mark.parametrize("case", ["gz_input", "no_trailing_newline",
                                  "partial_last_record", "small_memory"])
def test_barcode_sort_equals_jax(tmp_path, case, backend):
    if backend == "gnu" and shutil.which("sort") is None:
        pytest.skip("no GNU sort on PATH")
    inp = _sort_input(str(tmp_path), case)
    mem = 2 << 10 if case == "small_memory" else 512 << 20
    want = str(tmp_path / "want.fq")
    jfastq.barcode_sort_interleaved(inp, want, mem_limit=mem,
                                    backend="python")
    got = str(tmp_path / "got.fq")
    tfastq.barcode_sort_interleaved(inp, got, mem_limit=mem,
                                    backend=backend)
    assert _read(got) == _read(want)
    if backend != "native":   # gzipped output: the Python writer
        tfastq.barcode_sort_interleaved(inp, got + ".gz", mem_limit=mem,
                                        backend=backend)
        assert _read(got + ".gz") == _read(want)
    recs = list(tfastq.iter_fastq_records(got))
    tags = [r.header.split("BX:Z:")[1].split()[0] if "BX:Z:" in r.header
            else "~~~" for r in recs[::2]]
    assert tags == sorted(tags) and tags[-1] == "~~~"


def test_barcode_sort_auto_and_native_fallback(tmp_path, caplog):
    """More top-level radix buckets than the native sort's cap (600):
    it fails, warns, and GNU sort writes the same bytes; ``auto`` picks
    the native sort for plain output."""
    if shutil.which("sort") is None:
        pytest.skip("no GNU sort on PATH")
    inp = str(tmp_path / "many.fq")
    chars = [chr(c) for c in range(48, 123) if chr(c).isalnum()]
    with open(inp, "w") as f:
        for i, (a, b) in enumerate((a, b) for a in chars for b in chars):
            if i % 4:
                continue
            for _ in (1, 2):
                f.write(f"@r{i}\tBX:Z:{a}{b}x-1\nACGT\n+\nIIII\n")
    want = str(tmp_path / "want.fq")
    jfastq.barcode_sort_interleaved(inp, want, backend="python")
    got = str(tmp_path / "got.fq")
    with caplog.at_level(logging.WARNING):
        tfastq.barcode_sort_interleaved(inp, got, backend="native")
    assert "falling back to GNU sort" in caplog.text
    assert _read(got) == _read(want)
    small = _sort_input(str(tmp_path), "gz_input")
    calls = []
    real = tfastq._native_barcode_sort
    tfastq._native_barcode_sort = lambda *a: (calls.append(a), real(*a))
    try:
        tfastq.barcode_sort_interleaved(small, str(tmp_path / "auto.fq"))
    finally:
        tfastq._native_barcode_sort = real
    assert len(calls) == 1


# ---- hybrid mode -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2023, 2 ** 31 + 5])
def test_glibc_rand_equals_jax(seed):
    a, b = GlibcRand(seed), jutils.GlibcRand(seed)
    assert [a.rand() for _ in range(500)] == [b.rand() for _ in range(500)]


def test_hybrid_barcodes_equal_jax(tmp_path):
    """make_longread_barcode_map (FASTQ and FASTA), add_barcode's draws
    among several candidates, assign_barcodes' interleaved output."""
    lr_fq, lr_fa = str(tmp_path / "long.fq"), str(tmp_path / "long.fa")
    with open(lr_fq, "w") as f, open(lr_fa, "w") as g:
        for i in range(4):
            f.write(f"@L{i} some comment\n{'ACGT' * 20}\n+\n{'I' * 80}\n")
            g.write(f">L{i} other\n{'ACGT' * 10}\n{'TTGA' * 10}\n")
    bam = str(tmp_path / "s2l.bam")
    with BamWriter(bam, ["L0", "L1", "L2", "L3", "L9"], [80] * 5) as w:
        for i in range(50):
            name = f"s{i}"
            for j in range(i % 5):    # 0-4 candidate alignments
                cig = [("M", 70)] if (i + j) % 6 else [("M", 30), ("S", 40)]
                w.write(BamRecord(name, FPAIRED | FREAD1, (i + j) % 5, 0,
                                  60, cig, "A" * 70, "I" * 70, {}))
            if i % 7 == 0:
                w.write(BamRecord(name, FPAIRED | FREAD1 | FUNMAP, -1, -1,
                                  0, [], "C" * 70, "I" * 70, {}))
    r1, r2 = str(tmp_path / "s1.fq"), str(tmp_path / "s2.fq")
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(52):
            f1.write(f"@s{i} 1:N\nACGTACGT\n+\nIIIIIIII\n")
            f2.write(f"@s{i} 2:N\nTTGATTGA\n+\nIIIIIIII\n")
    for name, pkg in (("t", thybrid), ("j", jhybrid)):
        d = tmp_path / name
        d.mkdir()
        assert pkg.make_longread_barcode_map(lr_fq, str(d / "fq_map")) == 4
        assert pkg.make_longread_barcode_map(lr_fa, str(d / "fa_map")) == 4
        out_map = pkg.add_barcode(bam, str(d / "fq_map"), str(d / "sb"))
        assert pkg.assign_barcodes(out_map, r1, r2, str(d / "inter.fq")) == 52
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"),
                ["fq_map", "fa_map", "sb_map.txt", "inter.fq"])
    picked = _read(tmp_path / "t" / "sb_map.txt").decode().split("\n")
    assert len({ln.split()[1] for ln in picked if " " in ln}) > 2


def _hybrid_args(r1, r2, longreads, out, **kw):
    return argparse.Namespace(short_type="short", reads1=r1, reads2=r2,
                              longreads=longreads, index="", whitelist="",
                              output=out, threads=2, **kw)


def test_hybrid_preprocess_reads_equals_jax(tmp_path, monkeypatch):
    """The builtin short-to-long mapper (no bwa on PATH) on the
    tests/test_hybrid_e2e.py fixture: the BAM, the barcode map and the
    sorted FASTQ byte-equal to pangaea_tpu's."""
    monkeypatch.setattr(ToolRunner, "available", lambda self, tool: False)
    monkeypatch.setattr(JaxToolRunner, "available", lambda self, tool: False)
    long_fq, r1, r2, _ = make_hybrid_data(tmp_path)
    dirs = {}
    for name, mod, runner, kw in (
            ("t", tdriver, ToolRunner(), dict(device="cpu")),
            ("j", jdriver, JaxToolRunner(), {})):
        out = str(tmp_path / name)
        dirs[name] = os.path.join(out, "0_preprocess_reads")
        mod.preprocess_reads(_hybrid_args(r1, r2, long_fq, out, **kw),
                             dirs[name], runner)
    _same_files(dirs["t"], dirs["j"],
                ["barcode_maps.txt", "short2long.bam",
                 "short_reads_barcoded_map.txt",
                 "interleaved_link_reads.sorted.fastq"])


# ---- the driver ------------------------------------------------------------

def test_driver_stlfr_step1_equals_jax(tmp_path, monkeypatch, root_logging):
    """driver.main -s stlfr -w (whitelist) -st 1 on both packages (the
    port on device cpu): the sorted FASTQ and the feature CSVs."""
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda: None)
    (r1, r2, wl), _ = _stlfr(tmp_path, tsim)
    common = ["-s", "stlfr", "-1", r1, "-2", r2, "-w", wl, "-c", "2",
              "-t", "2", "-st", "1", "--skip-external"]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    res = tdriver.main(common + ["-o", out_t, "--device", "cpu"])
    jdriver.main(common + ["-o", out_j])
    _same_files(os.path.join(out_t, "0_preprocess_reads"),
                os.path.join(out_j, "0_preprocess_reads"),
                ["stlfr_1.fq", "stlfr_2.fq",
                 "interleaved_link_reads.sorted.fastq"])
    feats = sorted(f for f in os.listdir(os.path.join(out_j, "1.features"))
                   if f.endswith(".gz"))
    assert feats
    _same_files(os.path.join(out_t, "1.features"),
                os.path.join(out_j, "1.features"), feats)
    assert set(res["step0_s"]) == {"preprocess_s", "interleave_s", "sort_s"}
    assert res["pipeline"].cfg.feature.kmer == 15


def test_driver_raises_without_a_card_and_passes_its_flags(monkeypatch,
                                                           tmp_path,
                                                           root_logging):
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdriver.main(["-1", "a", "-2", "b", "-o", str(tmp_path / "o")])
        assert not os.path.exists(tmp_path / "o")
    seen = {}

    class Stub:
        def __init__(self, cfg, device=None):
            seen.update(cfg=cfg, device=device)
            self.cfg = cfg

        def run(self):
            pass

    import pangaea_tpu_torch.pipeline.run as run_mod
    monkeypatch.setattr(run_mod, "Pipeline", Stub)
    monkeypatch.setattr(tdriver, "preprocess_reads",
                        lambda args, d, runner, stats=None: "sorted.fq")
    tdriver.main(["-1", "a", "-2", "b", "-o", str(tmp_path / "p"),
                  "--device", "cpu", "--matmul_dtype", "bfloat16",
                  "-st", "2,3", "--skip-external"])
    cfg = seen["cfg"]
    assert seen["device"] == "cpu"
    assert (cfg.interleaved_reads, cfg.model.matmul_dtype, cfg.steps,
            cfg.cluster.n_clusters, cfg.threads) == \
        ("sorted.fq", "bfloat16", "2,3", 30, 50)
    assert (cfg.feature.spill_store, cfg.feature.spill_dir) == ("auto", None)


def _recording(base):
    """A ToolRunner of ``base``'s package that pretends every tool exists,
    records each command, and fabricates the files later stages read."""

    class Recording(base):
        def __init__(self, effects=None):
            super().__init__()
            self.commands = []
            self.effects = effects or {}

        def available(self, tool):
            return True

        def require(self, tool):
            pass

        def run(self, command, log_name=None, shell_cmd=None, cwd=None):
            display = shell_cmd or " ".join(command)
            self.commands.append((display, log_name, cwd))
            for key, fn in self.effects.items():
                if key in display:
                    fn(display)
    return Recording


def test_driver_external_commands_equal_jax(tmp_path):
    """metaSPAdes, Athena (its config.json too), the hybrid template
    assemblers and hybrid bwa mapping: pangaea_tpu's command lines."""
    long_fq, r1, r2, _ = make_hybrid_data(tmp_path)
    got = {}
    for name, mod, base in (("t", tdriver, ToolRunner),
                            ("j", jdriver, JaxToolRunner)):
        out = str(tmp_path / name)
        args = _hybrid_args(r1, r2, long_fq, out, device="cpu")
        args.short_type = "10x"

        def empty_bam(cmd):
            path = cmd.split(" -o ")[1].split()[0]
            BamWriter(path, ["x"], [1]).close()

        runner = _recording(base)({"samtools sort -@ 2 -n": empty_bam})
        spades = mod.run_metaspades(args, runner)
        local, athena = mod.run_athena(args, r1, long_fq, runner)
        templates = [mod.make_hybrid_template(args, runner),
                     mod.make_hybrid_template(args, runner, "nanopore",
                                              "metaplatanus")]
        mod.preprocess_reads(args, os.path.join(out, "reads"), runner)
        cfg = _read(os.path.join(out, "2_athena_out", "config.json"))
        got[name] = [[(c.replace(out, "OUT"), log, cwd and cwd.replace(
            out, "OUT")) for c, log, cwd in runner.commands],
            [p.replace(out, "OUT") for p in (spades, local, athena,
                                             *templates)], cfg]
    assert got["t"] == got["j"]
    assert len(got["t"][0]) == 9
