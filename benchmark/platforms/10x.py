"""10x linked reads as step 0 writes them: one barcode-sorted, interleaved
gzip FASTQ, ``BX:Z:<barcode>-1`` on both mates, with qualities. The
pipeline reads it as it is, so there is no driver entry and no step 0
number."""

import os

import numpy as np

from benchmark import compare, gen


def simulate(cfg: dict, traffic: dict, seed: int) -> gen.Inputs:
    rng = np.random.default_rng(seed)
    B = int(traffic["barcodes"])
    pair_bc, seq1, seq2, qual1, qual2, strain = gen.pairs(
        cfg, traffic, rng, with_qual=True)
    n = len(pair_bc)
    words = np.sort(gen._distinct_words(rng, B, int(cfg["barcode_len"])))
    names = np.char.add(b"r", np.char.zfill(np.arange(n).astype("S"), 7))
    return gen.Inputs({}, n, int(cfg["read_len"]), seq1, seq2, qual1, qual2,
                      names, pair_bc, words, strain, cfg["platform"])


def headers(inp: gen.Inputs) -> np.ndarray:
    """``@name\\tBX:Z:<barcode>-1``: the headers of step 0's output."""
    bc = inp.barcodes[inp.pair_barcode]
    return np.char.add(np.char.add(np.char.add(b"@", inp.names),
                                   b"\tBX:Z:"), np.char.add(bc, b"-1"))


def write(inp: gen.Inputs, cfg: dict, traffic: dict, out_dir: str,
          prefix: str) -> dict:
    h = headers(inp)
    path = os.path.join(out_dir, f"{prefix}.interleaved.fq.gz")
    gen.write_gzip(path, gen.pack_records([h, h], [inp.seq1, inp.seq2],
                                          [inp.qual1, inp.qual2]),
                   int(cfg["gzip_level"]))
    return {"interleaved": path}


def subset(inp: gen.Inputs, keep_barcodes: np.ndarray) -> gen.Inputs:
    return gen.take(inp, keep_barcodes[inp.pair_barcode])


def stream(inp: gen.Inputs) -> compare.Stream:
    return compare.Stream(inp.seq1, inp.seq2, inp.qual1, inp.qual2,
                          headers(inp), inp.pair_barcode, inp.barcodes)


def step0_numbers(out_dir: str, ref: compare.Reference) -> dict:
    return {}
