"""PyTorch port vs pangaea_tpu: the native FASTQ reader, the group-event
streams it feeds, and per-bin read extraction.

The port builds its own copy of the C++ reader (g++ into build/native);
on the same seeded simulator input it must return pangaea_tpu's arrays
bit for bit, with and without the quality plane, and its group-event
streams must equal pangaea_tpu's native streams batch for batch and the
Python packer's row for row. Paired extract_reads bin files must be
byte-equal to pangaea_tpu's. Unlike pangaea_tpu's reader, the port's
raises on a truncated or corrupt gzip input, as Python's gzip does, on
every native path (the reader, extract_reads, step 1).
"""

import gzip
import os
import zlib

import numpy as np
import pytest

from pangaea_tpu.io import extract_reads as jer
from pangaea_tpu.io import fast_packing as jfp
from pangaea_tpu.native import NativeFastqReader as JaxReader
from pangaea_tpu_torch.io import extract_reads as ter
from pangaea_tpu_torch.io import fast_packing as tfp
from pangaea_tpu_torch.io.grouping import (iter_barcode_groups,
                                           iter_read_pairs_interleaved,
                                           iter_read_pairs_paired)
from pangaea_tpu_torch.io.packing import GroupPacker
from pangaea_tpu_torch.io.sim import simulate_linked_reads
from pangaea_tpu_torch.kernels import build
from pangaea_tpu_torch.native import CorruptGzipError, NativeFastqReader

SIM = dict(n_species=3, genome_len=12_000, n_barcodes=200,
           pairs_per_barcode=12, read_len=90, error_rate=0.01,
           low_qual_rate=0.1, seed=17)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native")
    fq, r1, r2 = (str(d / n) for n in ("i.fq.gz", "r1.fq.gz", "r2.fq.gz"))
    simulate_linked_reads(out_interleaved=fq, **SIM)
    simulate_linked_reads(out_r1=r1, out_r2=r2, **SIM)
    return {"interleaved": fq, "r1": r1, "r2": r2}


def _read_all(cls, path, **kw):
    out = []
    with cls(path, **kw) as rd:
        while True:
            got = rd.read(700)
            if got is None:
                return out
            out.append(got)


@pytest.mark.parametrize("lowq", [False, True])
def test_native_reader_matches_jax(reads, lowq):
    kw = dict(max_len=96, name_width=64, with_lowq=lowq,
              min_qual_char="?" if lowq else None)
    for path in (reads["interleaved"], reads["r2"]):
        mine = _read_all(NativeFastqReader, path, **kw)
        theirs = _read_all(JaxReader, path, **kw)
        assert len(mine) == len(theirs) > 1
        for a, b in zip(mine, theirs):
            assert len(a) == len(b) == (5 if lowq else 4)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        if lowq:
            assert any(a[4].any() for a in mine)


def test_native_reader_reports_full_length_when_truncated(reads):
    """max_len below the read length truncates the codes but reports the
    full length (the overlong check of the group streams reads it)."""
    with NativeFastqReader(reads["interleaved"], max_len=1) as rd:
        codes, lengths, _ = rd.read(10)
    assert codes.shape == (10, 1) and (lengths == SIM["read_len"]).all()


def _events(stream):
    return [(k, p) for k, p in stream]


def _assert_events_equal(mine, theirs):
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    for (kind, a), (_, b) in zip(mine, theirs):
        if kind == "chunk":
            assert a == b
            continue
        assert a.rows_used == b.rows_used
        for f in ("codes", "lengths", "seg_ids", "cont", "lowq"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("form", ["interleaved", "paired", "paired_masked"])
def test_native_group_events_match_jax(reads, form):
    kw = dict(min_len=2000, max_read_len=96, reads_per_batch=256,
              groups_per_chunk=16, pairs_per_buffer=150, keep_dropped=True)
    if form == "interleaved":
        mine = tfp.native_group_events(reads["interleaved"], **kw)
        theirs = jfp.native_group_events(reads["interleaved"], **kw)
    else:
        mq = "?" if form == "paired_masked" else None
        mine = tfp.native_group_events_paired(reads["r1"], reads["r2"],
                                              min_qual_char=mq, **kw)
        theirs = jfp.native_group_events_paired(reads["r1"], reads["r2"],
                                                min_qual_char=mq, **kw)
    mine, theirs = _events(mine), _events(theirs)
    assert sum(k == "chunk" for k, _ in mine) > 1
    _assert_events_equal(mine, theirs)


def _rows(events, masked):
    """Per chunk, the sorted (seg, codes, lowq) rows of kept groups; and
    the sorted rows of dropped reads over the whole stream."""
    chunks, dropped, cur = [], [], []
    for kind, p in events:
        if kind == "chunk":
            chunks.append((p, sorted(cur)))
            cur = []
            continue
        for i in range(p.rows_used):
            n = int(p.lengths[i])
            row = (p.codes[i, :n].tobytes(),
                   p.lowq[i, :n].tobytes() if masked else b"")
            if p.seg_ids[i] >= 0:
                cur.append((int(p.seg_ids[i]),) + row)
            elif n:
                dropped.append(row)
    return chunks, sorted(dropped)


@pytest.mark.parametrize("form", ["interleaved", "paired_masked"])
def test_native_events_match_python_packer(reads, form):
    """The native stream and the Python packer (the reader's oracle) give
    the same chunks, the same kept rows per group and the same dropped
    rows, quality planes included."""
    gp = dict(min_len=2000, max_read_len=96, reads_per_batch=256,
              groups_per_chunk=16, keep_dropped=True)
    masked = form == "paired_masked"
    if masked:
        native = tfp.native_group_events_paired(
            reads["r1"], reads["r2"], min_qual_char="?", **gp)
        pairs = iter_read_pairs_paired(reads["r1"], reads["r2"],
                                       drop_unpaired=False)
    else:
        native = tfp.native_group_events(reads["interleaved"], **gp)
        pairs = iter_read_pairs_interleaved(reads["interleaved"])
    packer = GroupPacker(overlap=14, min_qual_char="?" if masked else None,
                         **gp).iter_events(iter_barcode_groups(pairs))
    n_chunks, n_drop = _rows(native, masked)
    p_chunks, p_drop = _rows(packer, masked)
    assert len(n_chunks) > 1 and n_drop
    assert n_chunks == p_chunks
    assert n_drop == p_drop


def _tree_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("form", ["interleaved", "paired"])
def test_extract_reads_bytes_equal_jax(reads, tmp_path, form):
    """Bin FASTQs and barcode files of the port's native extract_reads
    equal pangaea_tpu's byte for byte (clusters with an id -1 line and
    unclustered barcodes)."""
    bcs = []
    for _, _, b in _read_all(NativeFastqReader, reads["r1"], max_len=1):
        bcs += [x.decode() for x in b]
    uniq = sorted(set(bcs))
    tsv = str(tmp_path / "clusters.tsv")
    with open(tsv, "w") as f:
        f.write("3\t" + ",".join(uniq[0::3]) + "\n")
        f.write("-1\t" + ",".join(uniq[1::3]) + "\n")
        f.write("0\t" + ",".join(uniq[2::6]) + "\n")
    inp = (dict(interleaved=reads["interleaved"]) if form == "interleaved"
           else dict(reads1=reads["r1"], reads2=reads["r2"]))
    outs = {}
    for tag, fn in (("jax", jer.extract_reads), ("port", ter.extract_reads)):
        d = tmp_path / tag
        d.mkdir()
        paths = fn(tsv, str(d / "cluster"), **inp)
        assert [os.path.basename(p) for p in paths] == \
            ["cluster_bin3.fq", "cluster_bin0.fq"]
        outs[tag] = _tree_bytes(d)
    assert len(outs["jax"]) == 4 and all(outs["jax"].values())
    assert outs["port"] == outs["jax"]


def test_extract_reads_native_failure_raises(reads, tmp_path):
    tsv = str(tmp_path / "clusters.tsv")
    with open(tsv, "w") as f:
        f.write("0\tAAAA\n")
    with pytest.raises(OSError, match="native extract_reads failed"):
        ter.extract_reads(tsv, str(tmp_path / "missing" / "cluster"),
                          reads1=reads["r1"], reads2=reads["r2"])


def test_host_build_failure_raises_with_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( {\n")
    with pytest.raises(RuntimeError, match="build of broken failed") as e:
        build.load_host(str(src), "broken")
    assert "broken.cpp" in str(e.value)
    assert not any(n.startswith("libbroken")
                   for n in os.listdir(build.HOST_BUILD_DIR))


def test_overlong_read_raises_on_native_stream(reads):
    with pytest.raises(tfp.OverlongReadError):
        _events(tfp.native_group_events(reads["interleaved"], 2000, 64,
                                        256, 16, keep_dropped=True))


# ---- truncated and corrupt gzip input ----------------------------------------

def _damaged(data: bytes, kind: str) -> bytes:
    """A one-member .gz cut inside the deflate data, inside the 8-byte
    trailer or inside the header, or with one deflate byte flipped."""
    if kind == "member":
        return data[:len(data) // 2]
    if kind == "trailer":
        return data[:-4]
    if kind == "header":
        return data[:6]
    mid = len(data) // 2
    return data[:mid] + bytes([data[mid] ^ 0xFF]) + data[mid + 1:]


DAMAGE = ["member", "trailer", "header", "flipped"]


def _damaged_file(reads, tmp_path, kind):
    with open(reads["interleaved"], "rb") as f:
        data = f.read()
    path = str(tmp_path / f"{kind}.fq.gz")
    with open(path, "wb") as f:
        f.write(_damaged(data, kind))
    # what Python's gzip raises on the same bytes: the behaviour matched
    with pytest.raises(EOFError if kind != "flipped" else
                       (OSError, zlib.error)):
        with gzip.open(path) as f:
            f.read()
    return path, (EOFError if kind != "flipped" else CorruptGzipError)


@pytest.mark.parametrize("kind", DAMAGE)
def test_native_reader_raises_on_damaged_gzip(reads, tmp_path, kind):
    path, exc = _damaged_file(reads, tmp_path, kind)
    with pytest.raises(exc, match=os.path.basename(path)):
        _read_all(NativeFastqReader, path, max_len=96)
    if exc is CorruptGzipError:
        assert issubclass(exc, OSError)


@pytest.mark.parametrize("kind", DAMAGE)
def test_extract_reads_raises_on_damaged_gzip(reads, tmp_path, kind):
    path, _ = _damaged_file(reads, tmp_path, kind)
    tsv = str(tmp_path / "clusters.tsv")
    bcs = set()
    for _, _, b in _read_all(NativeFastqReader, reads["interleaved"],
                             max_len=1):
        bcs.update(x.decode() for x in b)
    with open(tsv, "w") as f:
        f.write("0\t" + ",".join(sorted(bcs)) + "\n")
    with pytest.raises(OSError, match="native extract_reads failed"):
        ter.extract_reads(tsv, str(tmp_path / "cluster"), interleaved=path)


@pytest.mark.parametrize("kind", DAMAGE)
def test_step1_raises_on_damaged_gzip_and_leaves_no_marker(reads, tmp_path,
                                                           kind):
    """The reader's error crosses the stream's prefetch thread to the
    caller of extract_features; step 1 writes no marker."""
    from pangaea_tpu_torch.config import FeatureConfig, PangaeaConfig
    from pangaea_tpu_torch.pipeline import Pipeline, check_step_finished
    path, exc = _damaged_file(reads, tmp_path, kind)
    out = str(tmp_path / "out")
    # auto_row_len off: the only native read is the stream's own
    cfg = PangaeaConfig(interleaved_reads=path, output=out, steps="1",
                        feature=FeatureConfig(auto_row_len=False,
                                              reads_per_batch=512))
    with pytest.raises(exc):
        Pipeline(cfg, device="cpu").run()
    assert not check_step_finished(out, "1")
    assert not os.path.exists(os.path.join(out, "1.features",
                                           "feature_finished"))


def _python_arrays(path, max_len):
    """The reader's (codes, lengths, barcodes) of every record, computed
    from Python's gzip."""
    from pangaea_tpu_torch.io.fastq import BarcodeParser, iter_fastq_records
    from pangaea_tpu_torch.kernels.encode import encode_bases
    parser = BarcodeParser()
    codes, lengths, bcs = [], [], []
    for rec in iter_fastq_records(path):
        row = np.full(max_len, 4, np.uint8)
        c = encode_bases(rec.seq.encode())[:max_len]
        row[:len(c)] = c
        codes.append(row)
        lengths.append(len(rec.seq))
        bcs.append(parser.parse(rec.header)[1].encode())
    return np.stack(codes), np.array(lengths, np.int32), np.array(bcs)


@pytest.mark.parametrize("form", ["whole", "bgzf", "zero_padded"])
def test_native_reader_whole_and_multi_member_gzip(reads, tmp_path, form):
    """A whole file, the same records as BGZF blocks (many members with
    the BC extra field) and a file with zero padding after its member all
    read byte-equal to Python's gzip."""
    from pangaea_tpu_torch.io.bam import bgzf_write
    src = reads["interleaved"]
    path = str(tmp_path / f"{form}.fq.gz")
    if form == "whole":
        path = src
    elif form == "bgzf":
        with gzip.open(src) as f, open(path, "wb") as out:
            bgzf_write(out, f.read(), block_size=5000)
    else:
        with open(src, "rb") as f, open(path, "wb") as out:
            out.write(f.read() + b"\0" * 100)
    got = _read_all(NativeFastqReader, path, max_len=96)
    want = _python_arrays(path, 96)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(np.concatenate([g[i] for g in got]), w)
    assert len(want[1]) == 2 * SIM["n_barcodes"] * SIM["pairs_per_barcode"]
