"""Raw stLFR reads as the sequencer leaves them: R1 and R2 gzip FASTQs
named ``@name#x_y_z/r`` in no particular order, and a whitelist of
barcode words. ``driver.main -s stlfr`` rewrites, interleaves and sorts
them (step 0), and the sorted file is compared record by record."""

import os

import numpy as np

from benchmark import compare, gen, reference


def simulate(cfg: dict, traffic: dict, seed: int) -> gen.Inputs:
    """Also draws the whitelist, each partition's distinct triple of
    whitelist entries and the raw file order. Exactly
    ``round(unbarcoded_share * pairs)`` pairs lose their barcode call
    (``0_0_0``), at most one per partition."""
    rng = np.random.default_rng(seed)
    B, P = int(traffic["barcodes"]), int(traffic["pairs_per_barcode"])
    pair_bc, seq1, seq2, qual1, qual2, strain = gen.pairs(
        cfg, traffic, rng, with_qual=False)
    n = len(pair_bc)
    n_wl = int(cfg["whitelist_size"])
    wl = gen._distinct_words(rng, n_wl, int(cfg["barcode_len"]))
    # distinct partition triples, 1-based indices into the whitelist
    tri = np.zeros((0, 3), np.int64)
    while len(tri) < B:
        draw = rng.integers(1, n_wl + 1, (2 * B, 3))
        _, first = np.unique(np.concatenate([tri, draw]), axis=0,
                             return_index=True)
        tri = np.concatenate([tri, draw])[np.sort(first)]
    tri = tri[:B]
    barcodes = np.char.add(np.char.add(wl[tri[:, 0] - 1], wl[tri[:, 1] - 1]),
                           wl[tri[:, 2] - 1])
    n_un = int(round(float(cfg["unbarcoded_share"]) * n))
    if n_un > B:
        raise ValueError("at most one unbarcoded pair per partition")
    lose = rng.permutation(B)[:n_un]
    pair_bc = pair_bc.copy()
    pair_bc[lose * P] = -1
    tags = np.char.add(np.char.add(np.char.add(
        tri[:, 0].astype("S"), b"_"), np.char.add(
        tri[:, 1].astype("S"), b"_")), tri[:, 2].astype("S"))
    tag = np.where(pair_bc >= 0, tags[np.repeat(np.arange(B), P)], b"0_0_0")
    order = rng.permutation(n)  # raw reads come off the sequencer unsorted
    names = np.char.add(b"sr", np.char.zfill(np.arange(n).astype("S"), 7))
    return gen.Inputs({}, n, int(cfg["read_len"]), seq1[order], seq2[order],
                      qual1[order], qual2[order], names, pair_bc[order],
                      barcodes, strain[order], cfg["platform"],
                      raw_tags=tag[order], whitelist=wl)


def write(inp: gen.Inputs, cfg: dict, traffic: dict, out_dir: str,
          prefix: str) -> dict:
    level = int(cfg["gzip_level"])
    stem = np.char.add(np.char.add(np.char.add(b"@", inp.names), b"#"),
                       inp.raw_tags)
    files = {}
    for mate, s, q in ((1, inp.seq1, inp.qual1), (2, inp.seq2, inp.qual2)):
        path = os.path.join(out_dir, f"{prefix}.R{mate}.fq.gz")
        h = np.char.add(stem, f"/{mate}".encode())
        gen.write_gzip(path, gen.pack_records([h], [s], [q]), level)
        files[f"r{mate}"] = path
    wl = os.path.join(out_dir, f"{prefix}.whitelist.txt")
    with open(wl, "wb") as f:
        f.write(b"".join(w + b"\t%d\n" % (i + 1)
                         for i, w in enumerate(inp.whitelist)))
    files["whitelist"] = wl
    return files


def subset(inp: gen.Inputs, keep_barcodes: np.ndarray) -> gen.Inputs:
    """The pairs of the kept partitions, and the unbarcoded pairs in
    proportion: every tenth pair of the file that is unbarcoded rides
    along."""
    sel = np.where(inp.pair_barcode >= 0,
                   keep_barcodes[np.maximum(inp.pair_barcode, 0)],
                   np.arange(inp.n_pairs) % 10 == 0)
    return gen.take(inp, sel)


def driver_argv(cfg: dict, files: dict) -> list:
    return ["-s", "stlfr", "-1", files["r1"], "-2", files["r2"],
            "-w", files["whitelist"]]


def stream(inp: gen.Inputs) -> compare.Stream:
    order, headers, bc = reference.stlfr_sorted(inp)
    return compare.Stream(inp.seq1[order], inp.seq2[order], inp.qual1[order],
                          inp.qual2[order], headers, bc, inp.barcodes)


def step0_numbers(out_dir: str, ref: compare.Reference) -> dict:
    return {"step0_records_off": compare.step0_records_off(out_dir, ref)}
