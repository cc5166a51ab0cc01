"""The comparison that decides ``correct``: each pass's outputs against the
plain reference (reference.py), one number per layer, each with a limit
from the configuration's ``limits``.

- step 0's numbers, from the platform's module (``step0_numbers``): on
  raw stLFR ``step0_records_off``, the records of step 0's barcode-sorted
  FASTQ that differ from the reference's sort (:func:`step0_records_off`);
- ``step1_entries_off``: barcode names and matrix entries of step 1's
  abundance and TNF CSVs that differ from the reference's;
- ``latent_gap``: the largest difference between a barcode's latent
  coordinate and the reference's, over the largest reference coordinate;
- ``clusters_off``: how far the count of distinct cluster labels lies
  from the cluster count the configuration asks for (``-c``);
- ``centroid_excess``: how far a barcode's own cluster mean lies beyond
  its nearest cluster mean (reference.centroid_excess), on the
  reference's latent;
- ``bin_records_off``: read pairs of the per-bin FASTQs that are missing,
  extra or out of order against the clusters the program chose and the
  reads of the pipeline's input.
"""

from __future__ import annotations

import collections
import csv
import functools
import glob
import gzip
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, Optional

import numpy as np

from benchmark import gen, reference

# step 0's barcode-sorted interleaved FASTQ, under a pass's output directory;
# the pipeline reads it after the driver's entry
STEP0_SORTED = os.path.join("0_preprocess_reads",
                            "interleaved_link_reads.sorted.fastq")


@dataclass
class Stream:
    """The pairs of the pipeline's input, in its order."""

    seq1: np.ndarray
    seq2: np.ndarray
    qual1: np.ndarray
    qual2: np.ndarray
    headers: np.ndarray   # (n,) S with '@', the same on both mates
    pair_bc: np.ndarray   # (n,) barcode id, -1 unbarcoded
    barcodes: np.ndarray  # (B,) S


def stream(inp: gen.Inputs) -> Stream:
    """The platform module's stream of ``inp``."""
    return inp.module.stream(inp)


def pair_bytes(s: Stream, sel: Optional[np.ndarray] = None) -> np.ndarray:
    """The interleaved FASTQ bytes of the pairs ``sel`` (all by default)."""
    sel = slice(None) if sel is None else sel
    h = s.headers[sel]
    return gen.pack_records([h, h], [s.seq1[sel], s.seq2[sel]],
                            [s.qual1[sel], s.qual2[sel]])


def _pairs_of(data: bytes):
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return [b"\n".join(lines[i:i + 8]) for i in range(0, len(lines), 8)]


def records_off(got: bytes, want: bytes) -> int:
    """Pairs in one and not the other, and 1 more if only the order
    differs; 0 when the bytes are equal."""
    if got == want:
        return 0
    a, b = collections.Counter(_pairs_of(got)), collections.Counter(
        _pairs_of(want))
    off = sum(((a - b) + (b - a)).values())
    return off if off else 1


@dataclass
class Reference:
    stream: Stream
    names: np.ndarray
    abd: np.ndarray
    tnf: np.ndarray
    latent_names: np.ndarray
    latent: np.ndarray
    module: ModuleType = field(default=None, repr=False)  # the platform's

    @functools.cached_property
    def stream_bytes(self) -> bytes:
        """The interleaved FASTQ bytes of the whole stream."""
        return pair_bytes(self.stream).tobytes()


def build_reference(inp: gen.Inputs, binning: dict, device,
                    precision: str = "float32") -> Reference:
    s = stream(inp)
    names, abd, tnf = reference.features(s.seq1, s.seq2, s.pair_bc,
                                         s.barcodes, binning, device)
    lnames, mu = reference.latent(names, abd, tnf, binning, device,
                                  precision)
    return Reference(s, names, abd, tnf, lnames, mu, inp.module)


def step0_records_off(out_dir: str, ref: Reference) -> int:
    """Records of step 0's sorted FASTQ unlike the reference's stream."""
    path = os.path.join(out_dir, STEP0_SORTED)
    got = open(path, "rb").read() if os.path.isfile(path) else b""
    return records_off(got, ref.stream_bytes)


def _read_csv_gz(path: str):
    with gzip.open(path, "rt", newline="") as f:
        rows = list(csv.reader(f))
    return (np.array([r[0] for r in rows]).astype("S"),
            np.array([r[1:] for r in rows], dtype=np.int64))


def step1_entries_off(feature_dir: str, ref: Reference, binning: dict
                      ) -> int:
    stem = (f"abundance.k{binning['k']}.v{binning['v']}.w{binning['s']}"
            f".m{binning['l']}.gz")
    total = 0
    for fname, want in ((stem, ref.abd), (f"tnf.m{binning['l']}.gz",
                                          ref.tnf)):
        path = os.path.join(feature_dir, fname)
        if not os.path.isfile(path):
            total += ref.names.size + want.size
            continue
        names, mat = _read_csv_gz(path)
        if names.shape != ref.names.shape or mat.shape != want.shape:
            total += max(names.size, ref.names.size) + max(mat.size,
                                                           want.size)
            continue
        total += int((names != ref.names).sum()) + int((mat != want).sum())
    return total


def _program_latent(model_dir: str):
    mu = np.load(os.path.join(model_dir, "latent.npz"))["arr_0"]
    names = np.load(os.path.join(model_dir, "barcodes.npz"),
                    allow_pickle=True)["arr_0"]
    return np.asarray(names).astype("S"), mu


def _aligned(names: np.ndarray, ref: Reference) -> Optional[np.ndarray]:
    """Rows of the reference latent in the order of ``names``, or None
    when the two hold different barcodes."""
    if len(names) != len(ref.latent_names):
        return None
    pos = {b: i for i, b in enumerate(ref.latent_names.tolist())}
    idx = [pos.get(b, -1) for b in names.tolist()]
    if min(idx, default=0) < 0 or len(set(idx)) != len(idx):
        return None
    return ref.latent[np.asarray(idx)]


def latent_gap(names: np.ndarray, mu: np.ndarray, ref: Reference) -> float:
    want = _aligned(names, ref)
    if want is None or mu.shape != want.shape:
        return float("inf")
    return float(np.abs(mu.astype(np.float64) - want).max()
                 / np.abs(want).max())


def bin_records_off(cluster_dir: str, labels: np.ndarray, names: np.ndarray,
                    ref: Reference) -> int:
    s = ref.stream
    bc_id = {b: i for i, b in enumerate(s.barcodes.tolist())}
    lab_of_bc = np.full(len(s.barcodes) + 1, -1, np.int64)
    for b, c in zip(names.tolist(), labels.tolist()):
        lab_of_bc[bc_id[b]] = c
    pair_lab = lab_of_bc[s.pair_bc]
    off = 0
    want_files = set()
    for c in np.unique(labels):
        path = os.path.join(cluster_dir, f"cluster_bin{c}.fq")
        want_files.add(os.path.abspath(path))
        sel = np.flatnonzero(pair_lab == c)
        want = pair_bytes(s, sel).tobytes()
        got = open(path, "rb").read() if os.path.isfile(path) else b""
        off += records_off(got, want)
    for path in glob.glob(os.path.join(cluster_dir, "cluster_bin*.fq")):
        if os.path.abspath(path) not in want_files:
            off += len(_pairs_of(open(path, "rb").read()))
    return off


def compare_pass(out_dir: str, ref: Reference, binning: dict
                 ) -> Dict[str, float]:
    """Every number of one pass's output directory, step 0's (from the
    platform's module) first."""
    nums: Dict[str, float] = dict(ref.module.step0_numbers(out_dir, ref))
    nums["step1_entries_off"] = step1_entries_off(
        os.path.join(out_dir, "1.features"), ref, binning)
    names, mu = _program_latent(os.path.join(out_dir, "2.vae"))
    nums["latent_gap"] = latent_gap(names, mu, ref)
    labels = np.load(os.path.join(out_dir, "3.clustering", "clusters.npz")
                     )["arr_0"]
    nums["clusters_off"] = abs(int(np.unique(labels).size)
                               - int(binning["clusters"]))
    want = _aligned(names, ref)
    nums["centroid_excess"] = (float("inf") if want is None or
                               len(labels) != len(want) else
                               reference.centroid_excess(want, labels))
    nums["bin_records_off"] = bin_records_off(
        os.path.join(out_dir, "3.clustering"), labels, names, ref)
    return nums


def worst(per_pass) -> Dict[str, float]:
    """The largest reading of each number over the passes."""
    out: Dict[str, float] = {}
    for nums in per_pass:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    return out
