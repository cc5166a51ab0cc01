"""Input generator: linked reads of a staggered mock community, from a seed.

A configuration (the sample, the platform's read geometry) and a traffic
mix (barcodes, pairs per barcode, the entry) give the files a pass reads.
What is shared lives here: :func:`pairs` draws the read pairs of every
platform, and the FASTQ and gzip writers. What belongs to one platform,
its barcodes, names, file layout and warm-up slice, lives in
``platforms/<platform>.py`` (see ``harness.py``), which :func:`simulate`,
:func:`write` and :func:`subset` reach through the configuration's
``platform``. Every seed gets the same amount of work:

- the barcode quota of each strain is the configuration's tier share of
  the barcodes, rounded by largest remainder (the same for every seed);
- each strain's base composition is its stated GC content;
- every barcode holds the same number of read pairs, drawn from one
  molecule of ``molecule_len`` bases.

The seed draws only the bases, which barcode belongs to which strain, the
molecule and read positions, the errors and the qualities, and what the
platform's module draws after them.

The gzip files are concatenated gzip members compressed in parallel, as
``bgzip`` writes them. Records are built as byte arrays with numpy, not
read by read.
"""

from __future__ import annotations

import concurrent.futures
import importlib.util
import os
import zlib
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List

import numpy as np

# the checkout root: platforms/ is found under <root>/benchmark
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    answer again. Per-pair arrays are in the order the platform's module
    writes them (for 10x the pipeline's barcode-sorted input, for stLFR
    the raw files' order)."""

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
    extra: dict = field(default_factory=dict)  # a platform's own arrays
    module: ModuleType = field(default=None, repr=False)  # platforms/<p>.py

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


def pairs(cfg: dict, traffic: dict, rng: np.random.Generator,
          with_qual: bool):
    """The read pairs every platform starts from, drawn from ``rng`` in a
    fixed order: the genomes, each barcode's strain and molecule, each
    pair's position, then each mate's errors and qualities. Returns
    ``(pair_barcode, seq1, seq2, qual1, qual2, pair_strain)`` with
    ``pairs_per_barcode`` pairs of each barcode in turn; qualities are all
    'I' unless ``with_qual``."""
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
    err, lq = float(cfg["error_rate"]), float(cfg.get("low_qual_rate", 0.0))
    qual1 = _mutate(seq1, rng, err, lq, with_qual)
    qual2 = _mutate(seq2, rng, err, lq, with_qual)
    return pair_bc, seq1, seq2, qual1, qual2, strain


def take(inp: Inputs, sel: np.ndarray) -> Inputs:
    """The pairs ``sel`` (a mask or index over pairs) of ``inp``, in the
    same order; what is not per pair (barcodes, whitelist, ``extra``) is
    kept whole."""
    return Inputs({}, int(inp.pair_barcode[sel].size), inp.read_len,
                  inp.seq1[sel], inp.seq2[sel], inp.qual1[sel],
                  inp.qual2[sel], inp.names[sel], inp.pair_barcode[sel],
                  inp.barcodes, inp.pair_strain[sel], inp.platform,
                  raw_tags=None if inp.raw_tags is None else inp.raw_tags[sel],
                  whitelist=inp.whitelist, extra=inp.extra,
                  module=inp.module)


# ---- the platform modules ---------------------------------------------------

def platform(name: str, root: str = ROOT) -> ModuleType:
    """``<root>/benchmark/platforms/<name>.py``, loaded by its path."""
    path = os.path.join(root, "benchmark", "platforms", name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no platform module {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_platform_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def simulate(cfg: dict, traffic: dict, seed: int, root: str = ROOT
             ) -> Inputs:
    """The pairs of one pass, in memory (no files), from the module of the
    configuration's ``platform``."""
    mod = platform(cfg["platform"], root)
    inp = mod.simulate(cfg, traffic, seed)
    inp.module = mod
    return inp


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


def write(inp: Inputs, cfg: dict, traffic: dict, out_dir: str,
          prefix: str) -> Dict[str, str]:
    """Write ``inp`` as the files the traffic's entry reads."""
    os.makedirs(out_dir, exist_ok=True)
    inp.files = inp.module.write(inp, cfg, traffic, out_dir, prefix)
    return inp.files


def subset(inp: Inputs, keep_barcodes: np.ndarray) -> Inputs:
    """The pairs of the barcodes ``keep_barcodes`` (a bool mask over
    barcode ids), as the platform's module chooses them."""
    out = inp.module.subset(inp, keep_barcodes)
    out.module = inp.module
    return out
