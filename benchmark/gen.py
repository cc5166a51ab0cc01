"""Input generator: linked reads of a staggered mock community, from a seed.

One general generator reads a configuration (the sample, the platform's
read geometry) and a traffic mix (barcodes, pairs per barcode, the input
kind) and writes the files a pass reads. Every seed gets the same amount
of work:

- the barcode quota of each strain is the configuration's tier share of
  the barcodes, rounded by largest remainder (the same for every seed);
- each strain's base composition is its stated GC content;
- every barcode holds the same number of read pairs, drawn from one
  molecule of ``molecule_len`` bases;
- on stLFR, exactly ``round(unbarcoded_share * pairs)`` pairs lose their
  barcode call (``0_0_0``), at most one per partition.

The seed draws only the bases, which barcode belongs to which strain, the
molecule and read positions, the errors and the qualities (and on stLFR
the whitelist, the partition triples and the raw file order).

The gzip files are concatenated gzip members compressed in parallel, as
``bgzip`` writes them. Records are built as byte arrays with numpy, not
read by read.
"""

from __future__ import annotations

import concurrent.futures
import os
import zlib
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
# ASCII -> index into ACGT (0..3); 255 elsewhere
_IDX = np.full(256, 255, np.uint8)
_IDX[ACGT] = np.arange(4, dtype=np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[ACGT] = np.frombuffer(b"TGCA", np.uint8)
# a uniform byte -> a quality below '?' (33..62) or at or above it (63..74)
_Q_LOW = (33 + np.arange(256) % 30).astype(np.uint8)
_Q_HIGH = (63 + np.arange(256) % 12).astype(np.uint8)


def quotas(total: int, shares: List[float]) -> np.ndarray:
    """Largest-remainder rounding of ``total * shares`` (ties go to the
    lower index), so the parts sum to ``total`` for every seed."""
    exact = np.asarray(shares, np.float64) * total / np.sum(shares)
    out = np.floor(exact).astype(np.int64)
    rest = exact - out
    order = sorted(range(len(rest)), key=lambda i: (-round(rest[i], 9), i))
    out[order[:total - int(out.sum())]] += 1
    return out


def strain_shares(cfg: dict) -> List[float]:
    tiers = cfg["sample"]["tier_shares"]
    return [tiers[s["tier"]] for s in cfg["sample"]["strains"]]


@dataclass
class Inputs:
    """What a pass reads, and what the reference needs to work out every
    answer again. Per-pair arrays are in the order of the pipeline's input
    file for 10x (barcode-sorted) and in raw file order for stLFR."""

    files: Dict[str, str]
    n_pairs: int
    read_len: int
    seq1: np.ndarray          # (n, L) ASCII
    seq2: np.ndarray
    qual1: np.ndarray
    qual2: np.ndarray
    names: np.ndarray         # (n,) S: read name without '@'
    pair_barcode: np.ndarray  # (n,) int32 barcode id, -1 = unbarcoded
    barcodes: np.ndarray      # (B,) S: barcode as the pipeline names it
    pair_strain: np.ndarray   # (n,) int16
    platform: str
    raw_tags: np.ndarray = field(default=None)  # stLFR (n,) S: x_y_z
    whitelist: np.ndarray = field(default=None)  # stLFR (n_wl,) S

    @property
    def n_reads(self) -> int:
        return 2 * self.n_pairs


def _genomes(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    strains = cfg["sample"]["strains"]
    g = int(cfg["genome_len"])
    gc = np.array([s["gc"] for s in strains], np.float64)
    # cumulative P(A), P(A)+P(C), P(A)+P(C)+P(G) per strain
    cum = np.stack([(1 - gc) / 2, 0.5 + 0 * gc, (1 + gc) / 2], axis=1)
    u = rng.random((len(strains), g), dtype=np.float32)
    idx = (u[:, :, None] >= cum[:, None, :].astype(np.float32)).sum(-1)
    return ACGT[idx]


def _distinct_words(rng: np.random.Generator, n: int, width: int
                    ) -> np.ndarray:
    """``n`` distinct ACGT words of ``width`` bases, as an (n,) S array."""
    out = np.zeros(0, dtype=f"S{width}")
    while out.size < n:
        draw = ACGT[rng.integers(0, 4, (2 * (n - out.size) + 8, width))]
        words = draw.view(f"S{width}").ravel()
        _, first = np.unique(np.concatenate([out, words]), return_index=True)
        keep = np.sort(first)
        out = np.concatenate([out, words])[keep]
    return out[:n]


def _mutate(seq: np.ndarray, rng: np.random.Generator, error_rate: float,
            low_qual_rate: float, with_qual: bool):
    """Substitute ``error_rate`` of the bases by another base; errored
    bases and ``low_qual_rate`` of the rest get a quality below '?'."""
    r = rng.integers(0, 1 << 16, seq.shape, dtype=np.uint16)
    err = r < int(error_rate * 65536)
    shift = rng.integers(1, 4, int(err.sum()), dtype=np.uint8)
    seq[err] = ACGT[(_IDX[seq[err]] + shift) % 4]
    if not with_qual:
        return np.full(seq.shape, ord("I"), np.uint8)
    low = r < int((error_rate + low_qual_rate) * 65536)
    q = rng.integers(0, 256, seq.shape, dtype=np.uint8)
    return np.where(low, _Q_LOW[q], _Q_HIGH[q])


def simulate(cfg: dict, traffic: dict, seed: int) -> Inputs:
    """The pairs of one pass, in memory (no files)."""
    rng = np.random.default_rng(seed)
    n_strains = len(cfg["sample"]["strains"])
    B, P = int(traffic["barcodes"]), int(traffic["pairs_per_barcode"])
    L, ins = int(cfg["read_len"]), int(cfg["insert_len"])
    mol = int(cfg["molecule_len"])
    genomes = _genomes(cfg, rng)
    g = genomes.shape[1]
    q = quotas(B, strain_shares(cfg))
    bc_strain = rng.permutation(np.repeat(np.arange(n_strains), q))
    mol_start = rng.integers(0, g - mol + 1, B)
    n = B * P
    pair_bc = np.repeat(np.arange(B, dtype=np.int32), P)
    start = mol_start[pair_bc] + rng.integers(0, mol - ins + 1, n)
    strain = bc_strain[pair_bc].astype(np.int16)
    win = np.lib.stride_tricks.sliding_window_view(genomes, L, axis=1)
    seq1 = win[strain, start]
    seq2 = _COMP[win[strain, start + ins - L][:, ::-1]]
    with_qual = cfg["platform"] == "10x"
    err, lq = float(cfg["error_rate"]), float(cfg.get("low_qual_rate", 0.0))
    qual1 = _mutate(seq1, rng, err, lq, with_qual)
    qual2 = _mutate(seq2, rng, err, lq, with_qual)

    if cfg["platform"] == "10x":
        words = np.sort(_distinct_words(rng, B, int(cfg["barcode_len"])))
        names = np.char.add(b"r", np.char.zfill(
            np.arange(n).astype("S"), 7))
        return Inputs({}, n, L, seq1, seq2, qual1, qual2, names, pair_bc,
                      words, strain, "10x")
    if cfg["platform"] != "stlfr":
        raise ValueError(f"no generator for platform {cfg['platform']!r}")
    n_wl = int(cfg["whitelist_size"])
    wl = _distinct_words(rng, n_wl, int(cfg["barcode_len"]))
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
    return Inputs({}, n, L, seq1[order], seq2[order], qual1[order],
                  qual2[order], names, pair_bc[order], barcodes,
                  strain[order], "stlfr", raw_tags=tag[order], whitelist=wl)


def pack_records(headers: List[np.ndarray], seqs: List[np.ndarray],
                 quals: List[np.ndarray]) -> np.ndarray:
    """FASTQ bytes of ``len(headers)`` records per row, row after row:
    ``header\\nseq\\n+\\nqual\\n`` each. Headers are S arrays (with '@');
    the result is one uint8 array."""
    n = len(headers[0])
    fixed = all((np.char.str_len(h) == h.dtype.itemsize).all()
                for h in headers)
    parts, masks = [], []
    for h, s, q in zip(headers, seqs, quals):
        hw = h.dtype.itemsize
        hb = np.frombuffer(h.tobytes(), np.uint8).reshape(n, hw)
        hlen = np.char.str_len(h)
        L = s.shape[1]
        block = np.empty((n, hw + 2 * L + 5), np.uint8)
        block[:, :hw] = hb
        block[:, hw] = 10
        block[:, hw + 1:hw + 1 + L] = s
        block[:, hw + 1 + L:hw + 4 + L] = np.frombuffer(b"\n+\n", np.uint8)
        block[:, hw + 4 + L:hw + 4 + 2 * L] = q
        block[:, -1] = 10
        parts.append(block)
        if not fixed:
            m = np.ones(block.shape, bool)
            m[:, :hw] = np.arange(hw)[None, :] < hlen[:, None]
            masks.append(m)
    if fixed:
        return np.concatenate(parts, axis=1).ravel()
    return np.concatenate(parts, axis=1)[np.concatenate(masks, axis=1)]


def write_gzip(path: str, data: np.ndarray, level: int, threads: int = 8,
               chunk: int = 4 << 20) -> None:
    """``data`` as concatenated gzip members compressed in parallel."""
    buf = memoryview(data)

    def member(i: int) -> bytes:
        c = zlib.compressobj(level, zlib.DEFLATED, 31)
        return c.compress(buf[i:i + chunk]) + c.flush()

    with concurrent.futures.ThreadPoolExecutor(threads) as pool, \
            open(path, "wb") as f:
        for blob in pool.map(member, range(0, len(buf), chunk)):
            f.write(blob)


def tenx_headers(inp: Inputs) -> np.ndarray:
    """``@name\\tBX:Z:<barcode>-1``: the headers of step 0's output."""
    bc = inp.barcodes[inp.pair_barcode]
    return np.char.add(np.char.add(np.char.add(b"@", inp.names),
                                   b"\tBX:Z:"), np.char.add(bc, b"-1"))


def write(inp: Inputs, cfg: dict, traffic: dict, out_dir: str,
          prefix: str) -> Dict[str, str]:
    """Write ``inp`` as the files the traffic's entry reads."""
    os.makedirs(out_dir, exist_ok=True)
    level = int(cfg["gzip_level"])
    if inp.platform == "10x":
        h = tenx_headers(inp)
        path = os.path.join(out_dir, f"{prefix}.interleaved.fq.gz")
        write_gzip(path, pack_records([h, h], [inp.seq1, inp.seq2],
                                      [inp.qual1, inp.qual2]), level)
        files = {"interleaved": path}
    else:
        stem = np.char.add(np.char.add(np.char.add(b"@", inp.names), b"#"),
                           inp.raw_tags)
        files = {}
        for mate, s, q in ((1, inp.seq1, inp.qual1), (2, inp.seq2, inp.qual2)):
            path = os.path.join(out_dir, f"{prefix}.R{mate}.fq.gz")
            h = np.char.add(stem, f"/{mate}".encode())
            write_gzip(path, pack_records([h], [s], [q]), level)
            files[f"r{mate}"] = path
        wl = os.path.join(out_dir, f"{prefix}.whitelist.txt")
        with open(wl, "wb") as f:
            f.write(b"".join(w + b"\t%d\n" % (i + 1)
                             for i, w in enumerate(inp.whitelist)))
        files["whitelist"] = wl
    inp.files = files
    return files


def subset(inp: Inputs, keep_barcodes: np.ndarray) -> Inputs:
    """The pairs of the barcodes ``keep_barcodes`` (a bool mask over
    barcode ids), in the same order; on stLFR the unbarcoded pairs of
    those partitions' reads are kept in proportion (every tenth pair of
    the file that is unbarcoded rides along)."""
    sel = np.where(inp.pair_barcode >= 0,
                   keep_barcodes[np.maximum(inp.pair_barcode, 0)],
                   np.arange(inp.n_pairs) % 10 == 0)
    return Inputs({}, int(sel.sum()), inp.read_len, inp.seq1[sel],
                  inp.seq2[sel], inp.qual1[sel], inp.qual2[sel],
                  inp.names[sel], inp.pair_barcode[sel], inp.barcodes,
                  inp.pair_strain[sel], inp.platform,
                  raw_tags=None if inp.raw_tags is None else inp.raw_tags[sel],
                  whitelist=inp.whitelist)
