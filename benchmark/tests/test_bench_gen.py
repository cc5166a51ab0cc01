"""Every seed gets the same amount of work."""

import json
import os

import numpy as np

from benchmark import gen

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
    import gzip
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
