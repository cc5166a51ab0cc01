"""Every seed gets the same amount of work, and a seed writes the same
files it always wrote."""

import gzip
import hashlib
import json
import os

import numpy as np
import pytest

import tiny
from benchmark import gen, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(config, traffic):
    with open(os.path.join(ROOT, "benchmark", "configs", config)) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", traffic)) as f:
        tr = json.load(f)
    cfg.update(genome_len=30000, molecule_len=8000)
    tr.update(barcodes=400, pairs_per_barcode=6)
    return cfg, tr


def test_quotas_largest_remainder():
    q = gen.quotas(12500, [0.18] * 5 + [0.018] * 5 + [0.0018] * 5
                   + [0.0002] * 5)
    assert q.sum() == 12500
    assert list(q[:5]) == [2250] * 5 and list(q[5:10]) == [225] * 5
    assert list(q[10:15]) == [23] * 5 and list(q[15:]) == [2] * 5


def test_two_seeds_do_the_same_work():
    for config, traffic in (("10x-atcc.json", "bin.json"),
                            ("stlfr-atcc.json", "raw.json")):
        cfg, tr = _load(config, traffic)
        a = gen.simulate(cfg, tr, 1)
        b = gen.simulate(cfg, tr, 2 ** 40 + 3)
        assert a.n_reads == b.n_reads == 2 * 400 * 6
        for inp in (a, b):
            bc = inp.pair_barcode[inp.pair_barcode >= 0]
            per_bc = np.bincount(bc, minlength=len(inp.barcodes))
            strain_of_bc = np.zeros(len(inp.barcodes), np.int64)
            strain_of_bc[bc] = inp.pair_strain[inp.pair_barcode >= 0]
            got = np.bincount(strain_of_bc, minlength=20)
            assert list(got) == list(gen.quotas(400, gen.strain_shares(cfg)))
            assert len(set(inp.barcodes.tolist())) == len(inp.barcodes)
            if inp.platform == "10x":
                assert (per_bc == 6).all()
            else:
                assert (per_bc >= 5).all() and per_bc.sum() == 2400 - 48
        assert (a.pair_barcode < 0).sum() == (b.pair_barcode < 0).sum()
        assert not np.array_equal(a.seq1, b.seq1)
        again = gen.simulate(cfg, tr, 1)
        assert np.array_equal(a.seq1, again.seq1)
        assert np.array_equal(a.qual2, again.qual2)


def test_files_round_trip(tmp_path):
    cfg, tr = _load("10x-atcc.json", "bin.json")
    inp = gen.simulate(cfg, tr, 5)
    files = gen.write(inp, cfg, tr, str(tmp_path), "x")
    lines = gzip.open(files["interleaved"], "rb").read().split(b"\n")
    assert lines[0] == b"@r0000000\tBX:Z:" + inp.barcodes[0] + b"-1"
    assert lines[1] == inp.seq1[0].tobytes() and lines[4] == lines[0]
    assert lines[5] == inp.seq2[0].tobytes() and lines[7] == \
        inp.qual2[0].tobytes()
    cfg, tr = _load("stlfr-atcc.json", "raw.json")
    inp = gen.simulate(cfg, tr, 5)
    files = gen.write(inp, cfg, tr, str(tmp_path), "y")
    r2 = gzip.open(files["r2"], "rb").read().split(b"\n")
    assert r2[0] == b"@sr0000000#" + inp.raw_tags[0] + b"/2"
    assert r2[1] == inp.seq2[0].tobytes()

# sha256 of what each file make_inputs writes holds (gunzipped where it is
# gzip, whose bytes depend on the zlib build), at tiny.py's size. The pins
# were computed on the commit before the generator moved into
# platforms/<platform>.py, so they hold the move to the same inputs.
PINS = [
    ("10x-atcc.bin", 3, {
        "input.interleaved.fq.gz":
            "4e42ffcbf6ff730619422d0494deb682daaa8ed12d377ce25a43457acdafe75b",
        "warmup.interleaved.fq.gz":
            "ef2acc38194f5e3aa582ecbfa768d1be053d281696b93132da4edc57ab98a498",
    }),
    ("10x-atcc.bin", 2 ** 40 + 11, {
        "input.interleaved.fq.gz":
            "f08f07a255a343f5ff2be03f83185af3aaec3eafa0a0f7498ac3111d5ce8f5e7",
        "warmup.interleaved.fq.gz":
            "ebcbdcaac71b93048601b7c96aa5d274a6772fdc31df63322be5809b24f28788",
    }),
    ("stlfr-atcc.raw", 3, {
        "input.R1.fq.gz":
            "23851ed0f71b1a1eef54e3d44ace32966074ea64e8f28162a02e8dd7a4d1fa54",
        "input.R2.fq.gz":
            "c431a4b45da74429d268b2e00a9c948bef53258dffa5bc69c0bf9d81cbaba988",
        "input.whitelist.txt":
            "8134e0cfc606af46a38a8b7ef4a5326fa9f21d0f0bb1bebd0400a4cd60adc165",
        "warmup.R1.fq.gz":
            "102252e4384122a8da03c69c180c199abe357b31c09c870af2836a00ce188e64",
        "warmup.R2.fq.gz":
            "5c8aa8fb75c56b2a47fc00a73c40f8d525b34187253f1849cc990285cc86ed8b",
        "warmup.whitelist.txt":
            "8134e0cfc606af46a38a8b7ef4a5326fa9f21d0f0bb1bebd0400a4cd60adc165",
    }),
    ("stlfr-atcc.raw", 2 ** 40 + 11, {
        "input.R1.fq.gz":
            "8649d0724da9395f67f60deaf5f16af8212c0fb2342372188c28b1ec5c9c2f4d",
        "input.R2.fq.gz":
            "83f0fd6192d48f14aff60d32066ae3bcc448111a5b66141cdc50b68710f8bc80",
        "input.whitelist.txt":
            "e9b6c74643037332b69fdd94d3398dd5a389df3fdd11490d1e572c76e48beb9c",
        "warmup.R1.fq.gz":
            "38d868967959837dc4663ae3e8e374a9e789bfcf3713c15fd65c82cdb914b7e1",
        "warmup.R2.fq.gz":
            "3dd0fe5fbb3a49e1179c93ebc3e692abeb6709bdf38c95496973db7a485fa16a",
        "warmup.whitelist.txt":
            "e9b6c74643037332b69fdd94d3398dd5a389df3fdd11490d1e572c76e48beb9c",
    }),
]


@pytest.mark.parametrize("cell,seed,want", PINS,
                         ids=[f"{c}-{s}" for c, s, _ in PINS])
def test_inputs_are_pinned(tmp_path, cell, seed, want):
    root = tiny.make_root(tmp_path)
    work = str(tmp_path / "work")
    harness.make_inputs(harness.load_cell(root, cell), seed, work)
    got = {}
    for name in sorted(os.listdir(work)):
        with open(os.path.join(work, name), "rb") as f:
            data = f.read()
        if name.endswith(".gz"):
            data = gzip.decompress(data)
        got[name] = hashlib.sha256(data).hexdigest()
    assert got == want
