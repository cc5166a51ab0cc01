"""PyTorch port vs pangaea_tpu: the step-4 modules one by one.

The port's assembly layer is a copy of pangaea_tpu's host code plus one
device module, the k-mer vote mapper. On the same seeded inputs each port
module must give pangaea_tpu's output: BAM and FASTA bytes, unitig
contigs, low-abundance reads, circularization decisions, the mapper's
index table and votes bit for bit (on the CPU, the mapper's run-length
scan is the plain ``cummax``), and the same external command lines.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pangaea_tpu.asm import circular_logic as jcl
from pangaea_tpu.asm import fasta as jfa
from pangaea_tpu.asm import mapper as jmap
from pangaea_tpu.asm import naive as jnaive
from pangaea_tpu.asm import unmapped as jun
from pangaea_tpu.io import bam as jbam
from pangaea_tpu_torch.asm import circular_logic as tcl
from pangaea_tpu_torch.asm import fasta as tfa
from pangaea_tpu_torch.asm import mapper as tmap
from pangaea_tpu_torch.asm import naive as tnaive
from pangaea_tpu_torch.asm import unmapped as tun
from pangaea_tpu_torch.asm.tools import ToolRunner
from pangaea_tpu_torch.io import bam as tbam
from pangaea_tpu_torch.kernels import scan
from tests.test_asm import _oracle_assemble_unitigs


def rand_seq(n, rng):
    return "".join(rng.choice(list("ACGT"), n))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---- io/bam ---------------------------------------------------------------

def _records(mod, rng):
    recs = []
    for i in range(40):
        seq = rand_seq(int(rng.randint(1, 160)), rng)
        qual = "".join(chr(33 + int(q)) for q in rng.randint(0, 41, len(seq)))
        if i % 5 == 0:
            recs.append(mod.BamRecord(f"r{i}", mod.FPAIRED | mod.FUNMAP, -1,
                                      -1, 0, [], seq, "", {}))
            continue
        flag = mod.FPAIRED | (mod.FREAD1 if i % 2 else mod.FREAD2)
        if i % 3 == 0:
            flag |= mod.FREVERSE
        recs.append(mod.BamRecord(
            f"r{i}", flag, i % 3, int(rng.randint(0, 900)), 60,
            [("M", len(seq))], seq, qual,
            {"NM": int(rng.randint(0, 5)), "XS": 1.5, "RG": "g1"}))
    return recs


def test_bam_round_trip_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    refs, lens = ["c1", "c2", "c3"], [1000, 2000, 30]
    paths = {}
    for tag, mod in (("jax", jbam), ("port", tbam)):
        paths[tag] = str(tmp_path / f"{tag}.bam")
        with mod.BamWriter(paths[tag], refs, lens, text="@HD\n") as w:
            for rec in _records(mod, np.random.RandomState(3)):
                w.write(rec)
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    got = list(tbam.BamReader(paths["jax"]))
    want = _records(tbam, rng)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.qname, a.flag, a.tid, a.pos, a.cigar, a.seq) == \
            (b.qname, b.flag, b.tid, b.pos, b.cigar, b.seq)
        assert (a.qual, a.tags) == (b.qual, b.tags)
    reader = tbam.BamReader(paths["port"])
    assert reader.references == refs and reader.lengths == lens
    assert tbam.revcomp("ACGTNacgt") == jbam.revcomp("ACGTNacgt")


# ---- asm/fasta --------------------------------------------------------------

def test_fasta_ops_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(4)
    recs = [(f"s{i} desc {i}", rand_seq(int(rng.randint(5, 300)), rng))
            for i in range(12)]
    outs = {}
    for tag, mod in (("jax", jfa), ("port", tfa)):
        d = tmp_path / tag
        d.mkdir()
        a, b = str(d / "a.fa"), str(d / "b.fa")
        mod.write_fasta(a, recs, width=60)
        with open(b, "w") as f:
            f.write(">tail\nACGT")  # no trailing newline
        mod.concat_fastas([a, b], str(d / "cat.fa"))
        n = mod.rename_contigs(str(d / "cat.fa"), str(d / "ren.fa"), start=3)
        mod.filter_min_len(a, str(d / "min.fa"), 100)
        mod.filter_min_len(a, str(d / "min.fa"), 100, append=True)
        mod.subseq(a, ["s1", "s7", "s3"], str(d / "sub.fa"))
        with open(d / "names.txt", "w") as f:
            f.write("x\n\n y \n")
        outs[tag] = ({p: _bytes(str(d / p)) for p in
                      ("a.fa", "cat.fa", "ren.fa", "min.fa", "sub.fa")},
                     n, mod.fasta_sizes(a), list(mod.iter_fasta(a)),
                     mod.read_name_list(str(d / "names.txt")))
    assert outs["port"] == outs["jax"]


# ---- asm/naive --------------------------------------------------------------

def _naive_reads(k, err, circ):
    """The read set of tests/test_asm.py's string-oracle test."""
    rng = np.random.RandomState(k + int(err * 1000) + circ)
    genomes = ["".join(rng.choice(list("ACGT"), 600)) for _ in range(3)]
    reads = []
    for g in genomes:
        src = g + (g[:60] if circ else "")
        for _ in range(120):
            i = rng.randint(0, len(src) - 70)
            r = list(src[i:i + 70])
            for j in range(len(r)):
                if rng.rand() < err:
                    r[j] = "ACGT"[rng.randint(4)]
                if rng.rand() < 0.002:
                    r[j] = "N"
                if rng.rand() < 0.001:
                    r[j] = "RYSWKMBDHV"[rng.randint(10)]
            s = "".join(r)
            if rng.rand() < 0.1:
                s = s.lower()
            reads.append(s)
    return reads


@pytest.mark.parametrize("k,err,circ", [(31, 0.0, False), (15, 0.01, False),
                                        (21, 0.0, True), (31, 0.008, True)])
def test_naive_assembler_matches_jax(k, err, circ, tmp_path):
    reads = _naive_reads(k, err, circ)
    got = tnaive.assemble_unitigs(list(reads), k=k, min_len=60)
    assert got == jnaive.assemble_unitigs(list(reads), k=k, min_len=60)
    assert got == _oracle_assemble_unitigs(list(reads), k=k, min_len=60)
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    n_t = tnaive.assemble_fastq(fq, str(tmp_path / "t.fa"), k=k, min_len=60)
    n_j = jnaive.assemble_fastq(fq, str(tmp_path / "j.fa"), k=k, min_len=60)
    assert n_t == n_j
    assert _bytes(str(tmp_path / "t.fa")) == _bytes(str(tmp_path / "j.fa"))


# ---- asm/unmapped -----------------------------------------------------------

def test_extract_unmapped_bytes_equal_jax(tmp_path):
    """A BAM of mapped, unmapped, low-identity, short and reverse-strand
    pairs (written by pangaea_tpu's codec) and a depth file: the port's
    .list and .low_abd.fq equal pangaea_tpu's at each cutoff."""
    rng = np.random.RandomState(6)
    bam = str(tmp_path / "t.bam")
    refs = ["c1", "c2", "c3"]
    with jbam.BamWriter(bam, refs, [1000, 1000, 1000]) as w:
        for i in range(60):
            seq = rand_seq(100, rng)
            qual = "".join(chr(40 + int(q)) for q in rng.randint(0, 30, 100))
            unmapped = i % 4 == 0
            cols = 50 if i % 7 == 0 else 100
            for mate in (jbam.FREAD1, jbam.FREAD2):
                flag = jbam.FPAIRED | mate
                if unmapped:
                    flag |= jbam.FUNMAP
                if i % 3 == 0:
                    flag |= jbam.FREVERSE
                cigar = [] if unmapped else [("M", cols)]
                w.write(jbam.BamRecord(
                    f"p{i}", flag, -1 if unmapped else i % 3, 0, 60, cigar,
                    seq, qual, {"NM": int(rng.randint(0, 12))}))
    depth = str(tmp_path / "d.depth")
    with open(depth, "w") as f:
        f.write("contigName\tcontigLen\ttotalAvgDepth\n"
                "c1\t1000\t50.0\nc2\t1000\t12.0\nc3\t1000\t3.0\n")
    for cut in (10, 30):
        for tag, mod in (("jax", jun), ("port", tun)):
            counts = mod.extract_unmapped(bam, depth, cut,
                                          str(tmp_path / f"{tag}{cut}"))
            if tag == "jax":
                want = counts
        assert counts == want and counts[1] > 0
        for ext in (".list", ".low_abd.fq"):
            assert _bytes(str(tmp_path / f"port{cut}{ext}")) == \
                _bytes(str(tmp_path / f"jax{cut}{ext}"))
    assert tun.read_depth_file(depth, 10) == jun.read_depth_file(depth, 10)


# ---- asm/circular_logic -----------------------------------------------------

def _circle(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _rows(mod, L=2_000_000, rep=100_000):
    return [mod.CoordRow(1, rep, L - rep + 1, L),
            mod.CoordRow(L - rep + 1, L, 1, rep),
            mod.CoordRow(1, 20_000, 1, 20_000),
            mod.CoordRow(25_000, 45_000, 25_000, 45_000),
            mod.CoordRow(900_000, 950_000, 100, 50_100)]


def _span_rows(mod, q2):
    return [mod.CoordRow(1, 5_000, 1, 5_000, r_len=1_000_000, q_len=40_000,
                         r_name="tig", q_name="span"),
            mod.CoordRow(995_000, 1_000_000, q2, q2 + 5_000,
                         r_len=1_000_000, q_len=40_000, r_name="tig",
                         q_name="span")]


def test_circular_logic_matches_jax():
    """tests/test_circular.py's fixtures through both packages."""
    g = _circle(50_000, 1)
    for seq, kw in ((g + g[:5_000], dict(min_overlap=2_000)),
                    (g, {}), (g[:30_000] + g[:500], dict(min_overlap=2_000))):
        assert tcl.exact_overlap_trim(seq, **kw) == \
            jcl.exact_overlap_trim(seq, **kw)
    for rows in (_rows(tcl), _rows(tcl)[:2], _rows(tcl)[2:]):
        jrows = [jcl.CoordRow(**vars(r)) for r in rows]
        assert tcl.overcirc_region(rows) == jcl.overcirc_region(jrows)
        assert tcl.smooth_coords(rows) == jcl.smooth_coords(jrows)
    for q2 in (3_000, 9_000):
        assert [vars(e) for e in tcl.span_events(_span_rows(tcl, q2))] == \
            [vars(e) for e in jcl.span_events(_span_rows(jcl, q2))]
    text = ("1\t100\t200\t300\t100\t101\t99.5\t5000\t5000\t2.0\t2.0"
            "\ttigA\ttigB\n7\t8\t9\t10\t1\t1\t99\tx\ty\nbad\n")
    assert [vars(r) for r in tcl.parse_show_coords(text)] == \
        [vars(r) for r in jcl.parse_show_coords(text)]
    t = _circle(60_000, 3)
    q = t[10_000:14_000] + t[40_000:43_000]
    for qq in (q, tcl._revcomp_str(q)):
        assert [vars(r) for r in tcl.anchor_chain_coords("T", t, "Q", qq)] \
            == [vars(r) for r in jcl.anchor_chain_coords("T", t, "Q", qq)]
    t = _circle(100_000, 5)
    reads = [("head", t[1_000:5_000]), ("tail", t[-6_000:-500]),
             ("mid", t[45_000:55_000]), ("wrap", t[-2_000:] + t[:2_000])]
    got = tcl.terminal_read_names(t, iter(reads), window=20_000)
    assert got == jcl.terminal_read_names(t, iter(reads), window=20_000)
    assert got == ["head", "tail", "wrap"]
    for k in (5, 21, 31):
        a, b = tcl._kmer_positions(t[:3_000] + "N" + t[3_000:4_000], k)
        c, d = jcl._kmer_positions(t[:3_000] + "N" + t[3_000:4_000], k)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("case", ["span", "overcirc", "gap", "linear"])
def test_circularizer_matches_jax(tmp_path, monkeypatch, case):
    """make_circularizer's builtin floor (spanner assembly, anchor-chain
    span test, exact overlap trim) writes pangaea_tpu's bytes on the
    tests/test_circular.py cases."""
    from pangaea_tpu.asm.circularize import make_circularizer as jmake
    from pangaea_tpu.asm.tools import ToolRunner as JRunner
    from pangaea_tpu.config import AssemblyConfig as JAsm
    from pangaea_tpu.config import PangaeaConfig as JCfg
    from pangaea_tpu_torch.asm.circularize import make_circularizer as tmake
    from pangaea_tpu_torch.config import AssemblyConfig, PangaeaConfig
    n = 120_000
    C = _circle(n, 41)
    W = C[-12_000:] + C[:12_000]
    contigs, pool = {
        "span": ([("big", C + C[:2_000]), ("small", C[:1_000])],
                 [("span1", W)]),
        "overcirc": ([("big", C[:60_000] + C[:5_000])],
                     [("decoy", C[70_000:79_000])]),
        "gap": ([("tig1", C[200:])], [("span1", W), ("mid1", C[30_000:60_000])]),
        "linear": ([("lin1", C[:80_000])], [("mid1", C[90_000:110_000])]),
    }[case]
    outs = {}
    for tag, make, cfg_cls, asm_cls, runner_cls in (
            ("jax", jmake, JCfg, JAsm, JRunner),
            ("port", tmake, PangaeaConfig, AssemblyConfig, ToolRunner)):
        d = tmp_path / tag
        d.mkdir()
        cfa, pfa = str(d / "contigs.fa"), str(d / "pool.fa")
        tfa.write_fasta(cfa, contigs)
        tfa.write_fasta(pfa, pool)
        cfg = cfg_cls(output=str(d), threads=2, assembly=asm_cls(
            circularize_min_size=50_000, terminal_window=20_000))
        circ = make(cfg, runner_cls(log_dir=str(d / "logs")))
        monkeypatch.setattr(runner_cls, "available", lambda self, t: False)
        outs[tag] = _bytes(circ(cfa, pfa, str(d)))
    assert outs["port"] == outs["jax"]
    names = [ln for ln in outs["port"].decode().splitlines()
             if ln.startswith(">")]
    assert names == {"span": [">big_spanned", ">small"],
                     "overcirc": [">big_circularized"],
                     "gap": [">tig1_spanned"], "linear": [">lin1"]}[case]


# ---- asm/mapper ---------------------------------------------------------------

def _mapper_contigs(seed):
    """Contigs with a shared repeat (collisions), an N, lowercase bases
    and lengths past max_row_len (continuation rows)."""
    rng = np.random.RandomState(seed)
    rep = rand_seq(400, rng)
    contigs = [(f"c{i} len=x", rand_seq(900, rng) + rep + rand_seq(600, rng))
               for i in range(6)]
    contigs.append(("n1", rand_seq(300, rng) + "N" + rand_seq(500, rng)))
    contigs.append(("low", rand_seq(200, rng) + rand_seq(100, rng).lower()
                    + rand_seq(200, rng)))
    return contigs


def _mappers(k, contigs, **kw):
    j = jmap.KmerMapper(k=k, **kw)
    j.index_contigs(contigs)
    t = tmap.KmerMapper(k=k, device="cpu", **kw)
    t.index_contigs(contigs)
    return j, t


@pytest.mark.parametrize("k", [13, 7])
def test_mapper_index_table_bit_equal_jax(k):
    """k=13 is the pipeline's; at k=7 (16,384 entries) most k-mers
    collide, so the hash coin's both signs decide entries."""
    j, t = _mappers(k, _mapper_contigs(k), max_row_len=256, rows_per_batch=5)
    want = np.asarray(j.table)
    got = t.table.numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert t.contig_names == j.contig_names and \
        t.contig_lengths == j.contig_lengths
    filled = got[got != tmap._EMPTY]
    assert (filled > 0).any() and (filled < 0).any()
    if k == 7:  # collisions resolved both ways: min ids and max ids kept
        assert len(np.unique(np.abs(filled))) == len(_mapper_contigs(k))


def _map_inputs(contigs, rng):
    seqs = [s.upper() for _, s in contigs]
    reads = [seqs[0][100:250], seqs[2][500:650], seqs[5][1400:1550]]
    reads += [tbam.revcomp(seqs[1][200:350]), tbam.revcomp(seqs[3][50:200])]
    reads += [rand_seq(150, rng), rand_seq(90, rng), ""]
    reads += [seqs[4][10:160].replace("A", "N", 4), "N" * 150]
    reads += [seqs[0][:1500], seqs[1][100:400], seqs[6][:20]]  # long, short
    return reads


@pytest.mark.parametrize("k", [13, 7])
@pytest.mark.parametrize("max_row_len", [1024, 256])
def test_mapper_map_reads_bit_equal_jax(k, max_row_len):
    """Forward, reverse-complement, random, N-containing, empty and
    longer-than-max_row_len reads."""
    contigs = _mapper_contigs(k + 1)
    j, t = _mappers(k, contigs, max_row_len=max_row_len)
    reads = _map_inputs(contigs, np.random.RandomState(k))
    got, want = t.map_reads(reads), j.map_reads(reads)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    best, votes, nvalid = got
    if k == 13:
        assert list(best[:5]) == [0, 2, 5, 1, 3]
        assert (votes[:5] == 150 - 13 + 1).all()
        assert votes[5] < 10
    assert nvalid[7] == 0 and best[7] == -1  # the empty read


def test_map_reads_without_reads():
    t = tmap.KmerMapper(k=7, device="cpu")
    t.index_contigs([("c", "ACGT" * 50)])
    assert [a.shape for a in t.map_reads([])] == [(0,)] * 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_global_cummax_run_length_equals_row_wise(seed):
    """The mapper's flat scan of global run-start indices gives the
    row-wise run lengths pangaea_tpu takes with lax.cummax (axis=1), on
    random sorted rows with many ties."""
    rng = np.random.RandomState(seed)
    R, W = int(rng.randint(1, 300)), int(rng.randint(1, 260))
    s = np.sort(rng.randint(0, 6, (R, W)).astype(np.int32), axis=1)
    col = np.broadcast_to(np.arange(W, dtype=np.int32), (R, W))
    is_new = np.ones((R, W), bool)
    is_new[:, 1:] = s[:, 1:] != s[:, :-1]
    boundary = np.where(is_new, col, -1).astype(np.int32)
    want = np.where(s > 0, col - np.asarray(
        jax.lax.cummax(boundary, axis=1)) + 1, 0)
    glob = np.arange(R * W, dtype=np.int32).reshape(R, W)
    flat = torch.from_numpy(np.where(is_new, glob, np.iinfo(np.int32).min)
                            .astype(np.int32).ravel())
    last = scan.cummax(flat).numpy().reshape(R, W)
    got = np.where(s > 0, glob - last + 1, 0)
    np.testing.assert_array_equal(got, want)


def _pairs(contigs, rng, n, uniform):
    seqs = [s.upper() for _, s in contigs[:6]]
    out = []
    for i in range(n):
        g = seqs[i % len(seqs)]
        ln = 150 if uniform else int(rng.randint(40, 200))
        p = int(rng.randint(0, len(g) - ln))
        s1, s2 = g[p:p + ln], tbam.revcomp(g[p + 20:p + 20 + ln])
        if i % 9 == 0:
            s1 = rand_seq(ln, rng)
        if i % 11 == 0:
            s2 = s2[:30] + "N" * 10 + s2[40:]
        q = "".join(chr(35 + int(x)) for x in rng.randint(0, 38, ln))
        out.append((f"p{i}", s1, q, s2, q[::-1]))
    return out


@pytest.mark.parametrize("uniform", [True, False])
def test_map_pairs_to_bam_and_depth_bytes_equal_jax(tmp_path, uniform):
    contigs = _mapper_contigs(21)
    j, t = _mappers(13, contigs)
    pairs = _pairs(contigs, np.random.RandomState(5), 230, uniform)
    jb = jmap.map_pairs_to_bam(j, iter(pairs), str(tmp_path / "j.bam"),
                               batch_pairs=64)
    tb = tmap.map_pairs_to_bam(t, iter(pairs), str(tmp_path / "t.bam"),
                               batch_pairs=64)
    assert tb == jb and len(tb) >= 5
    assert _bytes(str(tmp_path / "t.bam")) == _bytes(str(tmp_path / "j.bam"))
    jmap.write_depth_file(str(tmp_path / "j.depth"), j.contig_names,
                          j.contig_lengths, jb)
    tmap.write_depth_file(str(tmp_path / "t.depth"), t.contig_names,
                          t.contig_lengths, tb)
    assert _bytes(str(tmp_path / "t.depth")) == \
        _bytes(str(tmp_path / "j.depth"))


def test_merge_olc_builtin_containment_matches_jax(tmp_path, monkeypatch):
    """Contained, novel and near-threshold local contigs against seeds
    (1,024-wide mapper rows): the port's filtered pool and final.asm.fa
    equal pangaea_tpu's."""
    from pangaea_tpu.asm.merge_olc import merge_olc as jmerge
    from pangaea_tpu.asm.tools import ToolRunner as JRunner
    from pangaea_tpu_torch.asm.merge_olc import merge_olc as tmerge
    rng = np.random.RandomState(12)
    seed, other = rand_seq(5000, rng), rand_seq(2500, rng)
    seeds = [("seed1", seed), ("seed2 x", other), ("tiny", seed[:300])]
    local = [("contained", seed[1000:3000]), ("novel", rand_seq(3000, rng)),
             ("edge", seed[3000:5000] + rand_seq(1100, rng)),
             ("rc", tbam.revcomp(other[100:2400])),
             ("short", rand_seq(500, rng))]
    outs = {}
    for tag, merge, runner_cls in (("jax", jmerge, JRunner),
                                   ("port", tmerge, ToolRunner)):
        d = tmp_path / tag
        d.mkdir()
        sfa, lfa = str(d / "seeds.fa"), str(d / "local.fa")
        tfa.write_fasta(sfa, seeds)
        tfa.write_fasta(lfa, local)
        monkeypatch.setattr(runner_cls, "available", lambda self, t: False)
        kw = {"device": "cpu"} if tag == "port" else {}
        final = merge(sfa, lfa, str(d / "olc"), **kw)
        outs[tag] = (_bytes(final), _bytes(str(
            d / "olc" / "pre-flye-input-contigs.filt.fa")))
    assert outs["port"] == outs["jax"]
    kept = outs["port"][1].decode()
    assert ">novel" in kept and ">contained" not in kept


def test_default_device_mapper_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmap.KmerMapper()


# ---- external branches: the same argv as pangaea_tpu -------------------------

class FakeRunner(ToolRunner):
    """Every tool present; commands recorded; outputs fabricated."""

    def __init__(self, effects=None):
        super().__init__()
        self.commands = []
        self.effects = effects or {}

    def available(self, tool):
        return True

    def run(self, command, log_name=None, shell_cmd=None, cwd=None):
        display = shell_cmd or " ".join(command)
        self.commands.append(display)
        for key, fn in self.effects.items():
            if key in display:
                fn(display, cwd)


def test_bin_assembly_external_commands(tmp_path):
    from pangaea_tpu_torch.asm.bin_assembly import (assemble_cluster_bins,
                                                    map_reads_to_contigs)
    cluster_dir = str(tmp_path / "3.clustering")
    os.makedirs(cluster_dir)
    for i in range(3):
        with open(os.path.join(cluster_dir, f"cluster_bin{i}.fq"), "w") as f:
            f.write("@r\nACGT\n+\nIIII\n")

    def megahit_effect(cmd, cwd):
        outdir = cmd.split("-o ")[1].split()[0]
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "final.contigs.fa"), "w") as f:
            f.write(f">tig {outdir}\nACGTACGT\n")

    stats = {}
    runner = FakeRunner({"megahit": megahit_effect})
    contigs = assemble_cluster_bins(cluster_dir, 16, runner, stats=stats)
    megahit_cmds = sorted(c for c in runner.commands if "megahit" in c)
    assert megahit_cmds == [
        f"megahit --12 {cluster_dir}/cluster_bin{i}.fq -t 16 -o "
        f"{cluster_dir}/cluster_bin{i}.megahit" for i in range(3)]
    assert [n for n, _ in tfa.iter_fasta(contigs)] == \
        ["contig_1", "contig_2", "contig_3"]
    assembly_dir = str(tmp_path / "4.assembly")

    def touch(name):
        def effect(cmd, cwd):
            open(os.path.join(assembly_dir, name), "w").close()
        return effect

    runner = FakeRunner({
        "bwa mem": touch("contigs.megahit.bam"),
        "jgi": touch("contigs.megahit.depth"),
        "samtools sort -n": touch("contigs.megahit.name_sorted.bam")})
    map_reads_to_contigs(cluster_dir, assembly_dir, 16, "inter.fq", "",
                         runner, device="cpu", stats=stats)
    pos = os.path.join(assembly_dir, "contigs.megahit.bam")
    assert runner.commands == [
        f"bwa index {contigs}",
        f"bwa mem -p -t 16 {contigs} inter.fq | samtools sort -@ 16 -o {pos}",
        f"jgi_summarize_bam_contig_depths --outputDepth "
        f"{assembly_dir}/contigs.megahit.depth {pos}",
        f"samtools sort -n -@ 16 {pos} -o "
        f"{assembly_dir}/contigs.megahit.name_sorted.bam"]
    assert stats["backend"] == {"bin_assembler": "megahit", "mapper": "bwa"}


@pytest.mark.parametrize("assembler", ["spades", "megahit"])
def test_low_assembly_external_command(tmp_path, assembler):
    from pangaea_tpu_torch.asm.final import low_assembly
    assembly_dir = str(tmp_path)
    fq = os.path.join(assembly_dir, "contigs.megahit_cut10.low_abd.fq")
    open(fq, "w").close()

    def effect(cmd, cwd):
        outdir = cmd.split("-o ")[1].split()[0]
        os.makedirs(outdir, exist_ok=True)
        name = "contigs.fasta" if "spades" in cmd else "final.contigs.fa"
        with open(os.path.join(outdir, name), "w") as f:
            f.write(">a\nAC\n")

    runner = FakeRunner({"metaspades.py": effect, "megahit": effect})
    ran = low_assembly(assembly_dir, "seeds.fa", 10, 32, assembler, runner)
    want = {"spades": f"metaspades.py --12 {fq} --only-assembler -m 5000 "
                      f"-t 32 --untrusted-contigs seeds.fa -o "
                      f"{fq[:-3]}.spades",
            "megahit": f"megahit --12 {fq} -t 32 -o {fq[:-3]}.megahit"}
    assert runner.commands == [want[assembler]]
    assert ran == {"spades": "metaspades", "megahit": "megahit"}[assembler]


def test_merge_olc_flye_command(tmp_path):
    from pangaea_tpu_torch.asm.merge_olc import merge_olc
    seeds = str(tmp_path / "seeds.fa")
    local = str(tmp_path / "local.fa")
    tfa.write_fasta(seeds, [("s1", "A" * 1500), ("s2", "C" * 500)])
    tfa.write_fasta(local, [("l1", "G" * 1200)])
    outdir = str(tmp_path / "olc")

    def bwa_effect(cmd, cwd):
        if "samtools sort" in cmd:  # empty BAM: nothing contained
            with tbam.BamWriter(os.path.join(outdir, "align-inputs.bam"),
                                ["s1"], [1500]):
                pass

    def flye_effect(cmd, cwd):
        d = cmd.split("--out-dir ")[1].split()[0]
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "assembly.fasta"), "w") as f:
            f.write(">f\nACGT\n")

    stats = {}
    runner = FakeRunner({"bwa mem": bwa_effect, "flye --meta": flye_effect})
    merge_olc(seeds, local, outdir, runner=runner, device="cpu", stats=stats)
    merged = os.path.join(outdir, "flye-input-contigs.fa")
    bam = os.path.join(outdir, "align-inputs.bam")
    assert runner.commands == [
        f"bwa index {seeds}",
        f"bwa mem -t 100 {seeds} {local} | samtools view -bS - | "
        f"samtools sort -o {bam} -",
        f"samtools index {bam}",
        f"flye --meta --subassemblies {merged} --out-dir "
        f"{outdir}/flye-asm-1 --threads 128 --min-overlap 1000"]
    seqs = [s for _, s in tfa.iter_fasta(merged)]
    assert (seqs.count("A" * 1500), seqs.count("C" * 500),
            seqs.count("G" * 1200)) == (6, 0, 1)
    assert stats["backend"] == {"containment": "bwa", "olc": "flye"}
