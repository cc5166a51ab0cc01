"""Step-1 orchestrator: streams reads through the feature kernels.

Port of pangaea_tpu/features.py: interleaved (-i) or paired (-1/-2)
input, k = 1..31, any input size, on the sort-join or the dense-table
paths, and jellyfish dump export/import.

The sort-join (``hist_impl`` 'auto' or 'sortjoin'; the only path at
k > 15, whose keys are int64): one pass over the FASTQ collects every
window's canonical k-mer key and the TNF counts; one sort
of all keys gives every window's global k-mer count and so its abundance
bin; a replay of the recorded group ids histograms the bins per barcode.
This replaces the reference's jellyfish + count_kmer + count_tnf fan-out
(src/feature.py:28-39), which reads the FASTQ three times.

- **Input.** The native C++ reader (io/fast_packing.py) streams the
  groups whenever the reference's boundary-leak grouping is kept
  (``bug_compat_boundary_leak``, the default), as pangaea_tpu does; the
  Python packer (io/packing.py) streams them otherwise. Both give the
  same batches' windows.
- **Quality masking.** jellyfish counts paired input with
  ``--min-qual-char`` (src/feature.py:76-86) and interleaved input
  unmasked (:94). On paired input with ``min_qual_char`` set the join is
  WEIGHTED: each window carries its unmasked key with weight 1 iff it
  survives masking (kernels/features.py §quality-masked sort-join).
- **Past the cap.** When the window set would exceed
  ``sortjoin_max_windows`` (estimated up front from a sample of the
  file, or found mid-stream), the stream is still read once: with
  ``spill_agg`` on (the default) each in-cap chunk of windows is
  aggregated on the device into unique runs (:class:`_SpillAgg`), whose
  run ids stay on the device, in host RAM or on disk (``spill_store``);
  with ``spill_agg='off'`` the raw keys go to host RAM and are joined
  one key range at a time (:meth:`FeatureExtractor._chunked_sortjoin_bins`).

The dense-table paths (``hist_impl`` 'scatter' or 'segsum', k <= 15):
:meth:`FeatureExtractor.global_kmer_table` counts every read of the
file(s) into a 4^k table on the device (the global pass, through the
native reader, quality-masked on paired input), then
:meth:`FeatureExtractor.group_features` streams the groups again and
looks each window's count up. pangaea_tpu's 'segsum' is its TPU
formulation of the same outputs; the port runs one table path for both
names. The same table is what
:meth:`FeatureExtractor.export_jellyfish_dump` writes and
:meth:`FeatureExtractor.import_jellyfish_dump` reads (the reference's
count_kmer ``-g`` input).

Artifact names and resume semantics mirror src/feature.py:42-44,67-123:
``abundance.k{k}.v{v}.w{w}.m{m}.gz``, ``tnf.m{m}.gz`` and the
``feature_finished`` marker. The .gz CSVs are comma-separated
``barcode,c0,c1,...`` like the C++ tools' output. The port writes no
``.pkl`` caches of them: those are pandas pickles, and the port does
not depend on pandas (steps 2-3 read the CSVs).
"""

from __future__ import annotations

import concurrent.futures
import csv
import gzip
import logging
import os
import shutil
import tempfile
import time
import zlib
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from pangaea_tpu_torch.config import FeatureConfig
from pangaea_tpu_torch.io.fast_packing import (OverlongReadError,
                                               native_group_events,
                                               native_group_events_paired,
                                               native_seq_batches)
from pangaea_tpu_torch.io.grouping import (iter_barcode_groups,
                                           iter_read_pairs_interleaved,
                                           iter_read_pairs_paired)
from pangaea_tpu_torch.io.packing import GroupPacker, PackedBatch
from pangaea_tpu_torch.io.prefetch import prefetch
from pangaea_tpu_torch.kernels.encode import (decode_kmers, encode_bases,
                                              kmer_value_dtype,
                                              num_canonical_kmers,
                                              revcomp_kmers_np)
from pangaea_tpu_torch.kernels.features import (abundance_histogram,
                                                abundance_histogram_from_bins,
                                                batch_kmer_keys,
                                                batch_kmer_keys_weighted,
                                                count_kmers_global,
                                                kmer_key_sentinel,
                                                make_global_table,
                                                map_run_bins,
                                                rank_lut_tensor,
                                                sortjoin_bins,
                                                sortjoin_bins_weighted,
                                                sortjoin_pad_size,
                                                spill_aggregate,
                                                spill_aggregate_weighted,
                                                tnf_histogram_segsum)
from pangaea_tpu_torch.native import NativeFastqReader
from pangaea_tpu_torch.utils import (DeviceLike, replacing, resolve_device,
                                     synchronize)

log = logging.getLogger(__name__)

# Tail-batch pad rows are trimmed from the sort in multiples of this many
# rows (pangaea_tpu's quantum, kept so the sorted window count — and the
# scan shapes — equal the reference package's).
_TRIM_QUANTUM = 2048

Features = Tuple[np.ndarray, np.ndarray, np.ndarray]
# a batch's windows: (keys,) or, on the weighted path, (keys, weights)
Part = Tuple[torch.Tensor, ...]
HostOrDevice = Union[np.ndarray, torch.Tensor]


class _SpillAgg:
    """Device pre-aggregation store of the past-the-cap spill.

    Phase A feeds whole untrimmed batch parts; every ``S`` parts are
    concatenated and aggregated on the device (kernels/features.py
    ``spill_aggregate*``: one sort -> per-window run ids + the chunk's
    unique (key, weight sum) runs). Run ids and unique runs stay on the
    device, go to host RAM, or go to disk (``FeatureConfig.spill_store``;
    'auto' is disk when ``spill_dir`` is set, else device until
    ``spill_device_budget`` bytes, then host). :meth:`finalize_bins` joins
    the unique runs of every chunk through the weighted sort-join and
    builds one run -> bin table per chunk; :meth:`batch_bins` maps a
    batch's windows to bins with one gather on the device. This matches
    the reference's constant-rate streaming (count_kmer.cpp:186-292 +
    jellyfish's RAM-bounded hash, src/feature.py:76-86).
    """

    n_buckets = 64  # key-hash partitions of the disk store

    def __init__(self, fe: "FeatureExtractor", weighted: bool,
                 per_batch: int):
        cfg = fe.cfg
        self.fe = fe
        self.weighted = weighted
        self.per_batch = per_batch
        self.S = max(1, min(cfg.spill_agg_windows,
                            cfg.sortjoin_max_windows) // per_batch)
        store = cfg.spill_store
        if store == "auto":
            store = "disk" if cfg.spill_dir else "device"
        if store not in ("device", "host", "disk"):
            raise ValueError(f"unknown spill_store {cfg.spill_store!r}")
        if store == "disk" and not cfg.spill_dir:
            raise ValueError("spill_store='disk' requires spill_dir")
        self.store = store
        self.budget = cfg.spill_device_budget
        self.dev_bytes = 0
        # int32 words per key in the disk store's rows: an int64 key
        # (k > 15) is stored as its (hi, lo) words
        self.key_words = kmer_value_dtype(cfg.kmer).itemsize // 4
        self.buf: List[Part] = []
        self.groups: List[dict] = []
        self.n_entries = 0  # unique runs joined in phase B
        self._cur_g = -1
        self._cur_bins: Optional[torch.Tensor] = None
        # disk mode keeps host RSS flat: unique runs append to
        # key-hash-partitioned bucket files (equal keys share a bucket,
        # so per-bucket joins are global and exact) carrying (chunk,
        # run_id) back-pointers, and the per-chunk run -> bin tables live
        # in memmapped files. Each extraction gets its own directory.
        self.dir = None
        if store == "disk":
            os.makedirs(cfg.spill_dir, exist_ok=True)
            self.dir = tempfile.mkdtemp(prefix="spill.", dir=cfg.spill_dir)
            self._bucket_paths = [os.path.join(self.dir, f"bucket_{b}.bin")
                                  for b in range(self.n_buckets)]
            for p in self._bucket_paths:
                open(p, "wb").close()

    # ---- phase A ---------------------------------------------------------

    def add_part(self, part: Part) -> None:
        """part: (keys[, weights]) device tensors of exactly per_batch
        windows."""
        self.buf.append(part)
        if len(self.buf) == self.S:
            self._flush()

    def finish(self) -> None:
        if self.buf:
            self._flush()

    def _flush(self) -> None:
        parts, self.buf = self.buf, []
        keys = torch.cat([p[0] for p in parts])
        k = self.fe.cfg.kmer
        if self.weighted:
            out = spill_aggregate_weighted(
                keys, torch.cat([p[1] for p in parts]), k=k)
        else:
            out = spill_aggregate(keys, k=k)
        del parts
        run_ids, uniq, uw, n_runs, n_valid = out
        uniq, uw = uniq[:n_valid], uw[:n_valid]
        n_win = keys.numel()
        grp = {"n_windows": n_win, "n_runs": n_runs, "n_valid": n_valid,
               "bins_table": None}
        # run ids, and per unique run its key and int32 weight sum
        cost = 4 * n_win + (uniq.element_size() + 4) * n_valid
        if self.store == "device" and self.dev_bytes + cost > self.budget:
            log.info("spill run-id store: device budget reached (%d B); "
                     "later chunks go to host RAM", self.dev_bytes)
            self.store = "host"
        if self.store == "device":
            grp.update(run_ids=run_ids, uniq=uniq, uw=uw)
            self.dev_bytes += cost
        elif self.store == "host":
            grp.update(run_ids=run_ids.cpu().numpy(),
                       uniq=uniq.cpu().numpy(), uw=uw.cpu().numpy())
        else:  # disk: run ids to a per-chunk file, uniques to buckets
            path = os.path.join(self.dir, f"runids_{len(self.groups)}.bin")
            run_ids.cpu().numpy().tofile(path)
            grp["run_ids"] = path
            self._bucket_append(uniq.cpu().numpy(), uw.cpu().numpy(),
                                len(self.groups))
        self.groups.append(grp)
        log.info("spill chunk %d aggregated: %d windows -> %d unique runs "
                 "(%.1fx), store=%s", len(self.groups), n_win,
                 max(1, n_valid), n_win / max(1, n_valid), self.store)

    def _bucket_append(self, uniq: np.ndarray, uw: np.ndarray,
                       chunk_id: int) -> None:
        """Append a chunk's unique runs to the key-hash bucket files as
        (key words..., weight, chunk, run_id) int32 rows: one key word for
        int32 keys, (hi, lo) for int64 keys, hashed from both words as
        pangaea_tpu hashes its split-word keys."""
        nv = uw.shape[0]
        if nv == 0:
            return
        if self.key_words == 1:
            hv = uniq.astype(np.uint32)
            words = [uniq.astype(np.int32)]
        else:
            hi = (uniq >> 32).astype(np.uint32)
            lo = (uniq & 0xFFFFFFFF).astype(np.uint32)
            hv = hi ^ (lo * np.uint32(2654435761))
            words = [hi.view(np.int32), lo.view(np.int32)]
        b = ((hv * np.uint32(2654435761)) >> np.uint32(26)).astype(np.int64)
        rows = np.column_stack(words + [uw.astype(np.int32),
                                        np.full(nv, chunk_id, np.int32),
                                        np.arange(nv, dtype=np.int32)])
        for bi in np.unique(b):
            with open(self._bucket_paths[bi], "ab") as f:
                rows[b == bi].tofile(f)

    # ---- phase B ---------------------------------------------------------

    def _table_size(self, g: dict) -> int:
        return max(1, g["n_runs"])

    def _finalize_disk(self) -> None:
        """Flat-RSS phase B: one bucket in memory at a time; bins go into
        per-chunk memmapped run -> bin tables."""
        tables = []
        for i, g in enumerate(self.groups):
            path = os.path.join(self.dir, f"table_{i}.npy")
            mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.int32,
                                           shape=(self._table_size(g),))
            mm[:] = -1
            tables.append(mm)
            g["bins_table"] = path
        nk = self.key_words
        for bi, p in enumerate(self._bucket_paths):
            rows = np.fromfile(p, np.int32).reshape(-1, nk + 3)
            if rows.shape[0] == 0:
                continue
            self.n_entries += rows.shape[0]
            keys = rows[:, 0]
            if nk == 2:
                keys = ((keys.view(np.uint32).astype(np.int64) << 32)
                        | rows[:, 1].view(np.uint32))
            bins = self.fe._chunked_sortjoin_bins([(keys, rows[:, nk])],
                                                  weighted=True)
            chunks, runs = rows[:, nk + 1], rows[:, nk + 2]
            for c in np.unique(chunks):
                m = chunks == c
                tables[c][runs[m]] = bins[m]
            log.info("disk spill: bucket %d/%d joined (%d entries)",
                     bi + 1, self.n_buckets, rows.shape[0])
        for mm in tables:
            mm.flush()

    def finalize_bins(self) -> None:
        """Join all chunks' unique (key, weight) runs; build one run ->
        bin table per chunk (-1 for the sentinel run). Within the device
        cap the join runs on the device over the device-resident and
        uploaded host-resident runs; past it, on the host ranged join."""
        if self.store == "disk":
            self._finalize_disk()
            return
        fe, groups = self.fe, self.groups
        dev = fe.device
        E = sum(g["n_valid"] for g in groups)
        self.n_entries = E
        if E <= fe.cfg.sortjoin_max_windows:
            c = fe.cfg
            keys = torch.cat([fe._to_device(g["uniq"]) for g in groups])
            wts = torch.cat([fe._to_device(g["uw"]) for g in groups])
            bins = sortjoin_bins_weighted(keys, wts, k=c.kmer,
                                          window=c.window_size,
                                          vector_size=c.vector_size)
            del keys, wts
        else:
            bins = torch.from_numpy(fe._chunked_sortjoin_bins(
                [(fe._to_host(g["uniq"]), fe._to_host(g["uw"]))
                 for g in groups], weighted=True))
        off = 0
        for g in groups:
            nv = g["n_valid"]
            table = torch.full((self._table_size(g),), -1, dtype=torch.int32,
                               device=bins.device)
            table[:nv] = bins[off:off + nv]
            off += nv
            g["bins_table"] = table
            del g["uniq"], g["uw"]
        del bins
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- phase C ---------------------------------------------------------

    def batch_bins(self, j: int) -> torch.Tensor:
        """Device (per_batch,) bins of global batch j (stream order);
        maps one chunk at a time."""
        g, r = divmod(j, self.S)
        if g != self._cur_g:
            grp = self.groups[g]
            rid = grp["run_ids"]
            if isinstance(rid, str):
                rid = np.fromfile(rid, dtype=np.int32)
            table = grp["bins_table"]
            if isinstance(table, str):
                table = np.load(table)
            self._cur_bins = None  # free the last chunk's bins first
            self._cur_bins = map_run_bins(self.fe._to_device(table),
                                          self.fe._to_device(rid))
            self._cur_g = g
        lo = r * self.per_batch
        return self._cur_bins[lo:lo + self.per_batch]

    def cleanup(self) -> None:
        """Remove the disk store's files (no-op for the other stores)."""
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)


class FeatureExtractor:
    # barcode groups per chunk: the per-chunk histograms are
    # (groups_per_chunk, columns) on the device
    groups_per_chunk = 8192
    # past the cap: aggregate the spilled windows on the device
    # (_SpillAgg) unless spill_agg='off'; a subclass whose joins are
    # collective (parallel.ShardedFeatureExtractor) keeps the raw spill
    _spill_aggregate = True

    def __init__(self, cfg: FeatureConfig, feature_dir: str,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._rl: Optional[int] = None  # auto row length for this extract
        self._pending_save = None
        # window counts, paths and phase seconds of the last extraction
        self.stats: dict = {}
        self.dir = feature_dir
        os.makedirs(feature_dir, exist_ok=True)
        c = cfg
        stem = f"abundance.k{c.kmer}.v{c.vector_size}.w{c.window_size}.m{c.min_length}"
        self.abd_gz = os.path.join(feature_dir, stem + ".gz")
        self.tnf_gz = os.path.join(feature_dir, f"tnf.m{c.min_length}.gz")
        self.marker = os.path.join(feature_dir, "feature_finished")

    # ---- row geometry -----------------------------------------------------

    @property
    def row_len(self) -> int:
        """Packed row width: the auto-sampled length when enabled, else
        cfg.max_read_len. The Python packer splits longer reads across
        continuation rows; the native path raises OverlongReadError and
        extract_features retries once at cfg.max_read_len."""
        return self._rl or self.cfg.max_read_len

    def _auto_row_len(self, reads1: str, reads2: str, interleaved: str,
                      sample: int = 50_000) -> Optional[int]:
        """Max read length over a prefix sample (through the native
        reader), rounded up to 8. Padding windows beyond the read cost
        sort and histogram work; an underestimate costs one retry, never
        wrong output."""
        c = self.cfg
        paths = [interleaved] if interleaved else [
            p for p in (reads1, reads2) if p]
        mx = 0
        remaining = sample
        for p in paths:
            with NativeFastqReader(p, max_len=1) as rd:
                while remaining > 0:
                    out = rd.read(min(65536, remaining))
                    if out is None:
                        break
                    mx = max(mx, int(out[1].max(initial=0)))
                    remaining -= len(out[1])
        if mx == 0:
            return None
        row = min(c.max_read_len, max(c.kmer, -(-mx // 8) * 8))
        if row != c.max_read_len:
            log.info("auto row length %d (sampled max read %d, "
                     "max_read_len %d)", row, mx, c.max_read_len)
        return row

    # ---- eligibility --------------------------------------------------------

    def sortjoin_eligible(self, reads1: str, reads2: str,
                          interleaved: str) -> bool:
        """The sort-join serves ``hist_impl`` 'auto' and 'sortjoin' at
        every k <= 31, on interleaved input and on paired input (the
        quality-masked global pass reproduced by the weighted join), at
        any size (the spill removes the window cap). pangaea_tpu's 'auto'
        takes the table path on its CPU backend; the outputs are the
        same."""
        c = self.cfg
        return (bool(interleaved or (reads1 and reads2))
                and c.hist_impl in ("auto", "sortjoin"))

    def _estimate_stream_windows(self, path_or_paths) -> Optional[int]:
        """Sorted-window count the sort-join would produce, estimated by
        parsing a decompressed prefix sample (up to 4 MiB of the file):
        records per compressed byte and packed rows per record are
        measured, then scaled to the file size. Exact when the sample
        covers the file. A (reads1, reads2) tuple sums both files."""
        if isinstance(path_or_paths, tuple):
            parts = [self._estimate_stream_windows(p)
                     for p in path_or_paths]
            if any(p is None for p in parts):
                return None
            return sum(parts)
        path = path_or_paths
        c = self.cfg
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                raw = f.read(4 << 20)
        except OSError:
            return None
        if not raw:
            return 0
        consumed = len(raw)
        if path.endswith((".gz", ".bgz")):
            data = bytearray()
            buf = bytes(raw)
            try:
                while buf:
                    d = zlib.decompressobj(wbits=31)
                    data += d.decompress(buf)
                    if not d.eof:
                        break  # member continues past the prefix
                    buf = d.unused_data
            except zlib.error:
                pass  # truncated tail of the prefix — expected
            text = bytes(data)
        else:
            text = raw
        lines = text.split(b"\n")
        nrec = (len(lines) - 1) // 4  # drop the trailing partial record
        if nrec == 0:
            return None
        rl, step = self.row_len, self.row_len - (c.kmer - 1)
        rows = 0
        for seq in lines[1:4 * nrec:4]:
            n = len(seq)
            rows += 1 if n <= rl else 1 + -(-(n - rl) // step)
        if consumed >= size:
            est_rows = rows  # whole file sampled: exact
        else:
            est_rows = int(rows * (size / consumed)) + 1
        wrow = rl - c.kmer + 1
        est_batches = -(-est_rows // c.reads_per_batch)
        return est_batches * c.reads_per_batch * wrow

    # ---- host stream ------------------------------------------------------

    def _group_events(self, reads1: str, reads2: str, interleaved: str):
        """("native" | "python", events): the ("batch", b) / ("chunk",
        names) group stream, with keep_dropped — the global counts must
        cover every read, like jellyfish over the whole file
        (src/feature.py:76-86). The native reader streams wherever
        pangaea_tpu's does (bug_compat_boundary_leak), the Python packer
        otherwise. Interleaved input wins when both forms
        are given. Paired streams carry mismatched R1/R2 pairs as
        global-only seg -1 reads (jellyfish counts them although
        count_kmer.cpp:195-197 skips them from grouping) and, when
        masked, the lowq plane."""
        c = self.cfg
        masked = bool(reads1 and reads2 and not interleaved
                      and c.min_qual_char)
        mq = c.min_qual_char if masked else None
        G = self.groups_per_chunk
        if c.bug_compat_boundary_leak:
            if interleaved:
                return "native", native_group_events(
                    interleaved, c.min_length, self.row_len,
                    c.reads_per_batch, G, keep_dropped=True)
            return "native", native_group_events_paired(
                reads1, reads2, c.min_length, self.row_len,
                c.reads_per_batch, G, keep_dropped=True, min_qual_char=mq)
        gp = GroupPacker(min_len=c.min_length, max_read_len=self.row_len,
                         overlap=c.kmer - 1,
                         reads_per_batch=c.reads_per_batch,
                         groups_per_chunk=G, keep_dropped=True,
                         min_qual_char=mq)
        pairs = (iter_read_pairs_interleaved(interleaved) if interleaved
                 else iter_read_pairs_paired(reads1, reads2,
                                             drop_unpaired=False))
        groups = iter_barcode_groups(pairs,
                                     bug_compat=c.bug_compat_boundary_leak)
        return "python", gp.iter_events(groups)

    def _host_tensors(self, events) -> Iterator:
        """Batch arrays as CPU tensors (codes, lengths, seg_ids, cont
        [, lowq]), page-locked when bound for the card (runs on the
        prefetch thread, so pinning overlaps the device work)."""
        pin = self.device.type == "cuda"
        for kind, payload in events:
            if kind == "batch":
                b: PackedBatch = payload
                arrays = [b.codes, b.lengths, b.seg_ids, b.cont]
                if b.lowq is not None:
                    arrays.append(b.lowq)
                ts = tuple(torch.from_numpy(a) for a in arrays)
                if pin:
                    ts = tuple(t.pin_memory() for t in ts)
                payload = (b, ts)
            yield kind, payload

    def _upload(self, ts):
        """Host batch tensors -> the device (asynchronous from pinned
        memory on the card)."""
        if self.device.type == "cpu":
            return ts
        return tuple(t.to(self.device, non_blocking=True) for t in ts)

    def _to_device(self, x: HostOrDevice) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device)

    @staticmethod
    def _to_host(x: HostOrDevice) -> np.ndarray:
        return x if isinstance(x, np.ndarray) else x.cpu().numpy()

    # ---- hooks (parallel.ShardedFeatureExtractor overrides them) -----------

    def _device_batch(self, host):
        """This extractor's rows of one host batch, on the device."""
        return self._upload(host)

    def _local_rows(self, rows: int) -> int:
        """How many of the first ``rows`` rows of a batch are this
        extractor's (all of them on one device)."""
        return rows

    def _sortjoin_window_cap(self) -> int:
        """Windows one in-cap sort-join may hold, summed over devices."""
        return self.cfg.sortjoin_max_windows

    def _sortjoin_pad_size(self, n: int) -> int:
        """Padded length of the in-cap join of ``n`` windows."""
        return sortjoin_pad_size(n)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of a device tensor over the devices that hold parts of the
        input (itself on one device): the per-group histograms, the
        ranged join's key-range counts and valid-window count."""
        return t

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenation of a 1-D device tensor over the devices, in rank
        order (itself on one device): the ranged join's key sample."""
        return t

    # ---- sort-join ----------------------------------------------------------

    def _pad_part(self, n: int, weighted: bool) -> Part:
        """n sentinel windows (weight 0 on the weighted path)."""
        k = self.cfg.kmer
        keys = torch.full((n,), kmer_key_sentinel(k),
                          dtype=kmer_value_dtype(k), device=self.device)
        if weighted:
            return keys, torch.zeros(n, dtype=torch.int32,
                                     device=self.device)
        return (keys,)

    def _bins(self, keys: torch.Tensor, weights: Optional[torch.Tensor]
              ) -> torch.Tensor:
        c = self.cfg
        if weights is None:
            return sortjoin_bins(keys, k=c.kmer, window=c.window_size,
                                 vector_size=c.vector_size)
        return sortjoin_bins_weighted(keys, weights, k=c.kmer,
                                      window=c.window_size,
                                      vector_size=c.vector_size)

    def group_features_sortjoin(self, reads1: str = "", reads2: str = "",
                                interleaved: str = "") -> Features:
        """Single-pass features via the sort-join abundance kernels.

        Phase A streams the group chunks once: per batch it collects the
        canonical k-mer key (and, masked, the weight) of every window and
        accumulates the TNF histogram. Phase B joins all keys to derive
        each window's global count == abundance bin: one sort in cap, the
        aggregated or the ranged spill past it. Phase C replays the
        recorded seg_ids to histogram the bins per barcode."""
        c = self.cfg
        dev = self.device
        overlap = c.kmer - 1
        ncols = num_canonical_kmers(c.tnf_kmer)
        lut = rank_lut_tensor(c.tnf_kmer, dev)
        G = self.groups_per_chunk
        cap = self._sortjoin_window_cap()
        rows = c.reads_per_batch
        wrow = self.row_len - c.kmer + 1
        per_batch = rows * wrow
        # the interleaved flow counts UNMASKED (src/feature.py:94), so
        # weighting requires paired-only input
        weighted = bool(reads1 and reads2 and not interleaved
                        and c.min_qual_char)
        t0 = time.perf_counter()
        io, events = self._group_events(reads1, reads2, interleaved)
        spill = False
        agg: Optional[_SpillAgg] = None
        est = self._estimate_stream_windows(
            interleaved if interleaved else (reads1, reads2))
        if est is not None and est * 21 // 20 > cap:
            log.info("sort-join spill mode: ~%d windows > device cap %d",
                     est, cap)
            spill = True
            if c.spill_agg != "off" and self._spill_aggregate:
                agg = _SpillAgg(self, weighted, per_batch)
        # device parts in cap; host numpy parts once spilled raw.
        # ``total`` counts the windows of whole batches, which every
        # device reads, so every device takes the same spill decisions;
        # ``local`` counts this extractor's windows
        keys_parts: List[Tuple] = []
        chunk_meta = []  # (names, [(seg_ids, kept_rows)], thist)
        segs = []
        thist = None
        total = local = 0
        ranges = 0
        try:
            for kind, payload in prefetch(self._host_tensors(events),
                                          depth=4):
                if kind == "chunk":
                    chunk_meta.append((payload, segs,
                                       thist if thist is not None
                                       else self._zeros(G, ncols)))
                    segs, thist = [], None
                    log.info("sortjoin pass A: %d barcodes, %d windows",
                             sum(len(m[0]) for m in chunk_meta), total)
                    continue
                b, host = payload
                codes, lengths, seg, cont, *lowq = self._device_batch(host)
                if thist is None:
                    thist = self._zeros(G, ncols)
                # a tail batch's trailing pad rows are pure sentinel sort
                # cost: keep only the filled rows, quantized
                kept_rows = rows
                if b.rows_used < rows:
                    kept_rows = min(rows, -(-b.rows_used // _TRIM_QUANTUM)
                                    * _TRIM_QUANTUM)
                mine = self._local_rows(kept_rows)
                if weighted:
                    # a missing plane would silently give UNMASKED counts
                    if not lowq:
                        raise RuntimeError("masked sort-join batch arrived "
                                           "without a lowq plane")
                    part = batch_kmer_keys_weighted(
                        codes, lowq[0], lengths, cont, k=c.kmer,
                        overlap=overlap)
                else:
                    part = (batch_kmer_keys(codes, lengths, cont, k=c.kmer,
                                            overlap=overlap),)
                if agg is not None:
                    # untrimmed: trailing pad windows are sentinel-keyed
                    # and collapse into the sentinel run
                    agg.add_part(part)
                    total += per_batch
                else:
                    if mine < len(seg):
                        part = tuple(w[:mine * wrow] for w in part)
                    if spill:
                        part = tuple(w.cpu().numpy() for w in part)
                    keys_parts.append(part)
                    total += kept_rows * wrow
                    local += len(part[0])
                segs.append((seg[:mine], mine))
                tnf_histogram_segsum(thist, codes, lengths, seg, cont,
                                     k=c.tnf_kmer, overlap=overlap,
                                     rank_lut=lut)
                if not spill and total > cap:
                    log.warning("sort-join overflow (%d windows > cap %d); "
                                "spilling and continuing (the stream is "
                                "still read once)", total, cap)
                    if c.spill_agg != "off" and self._spill_aggregate:
                        agg = _SpillAgg(self, weighted, per_batch)
                        for p in keys_parts:
                            short = per_batch - len(p[0])
                            if short:
                                # re-pad parts the trim cut: the cut
                                # windows were sentinel pad anyway
                                p = tuple(torch.cat([w, pw]) for w, pw in
                                          zip(p, self._pad_part(short,
                                                                weighted)))
                            agg.add_part(p)
                        keys_parts = []
                    else:
                        keys_parts = [tuple(w.cpu().numpy() for w in p)
                                      for p in keys_parts]
                    spill = True
            if thist is not None or segs:
                chunk_meta.append(([], segs, thist if thist is not None
                                   else self._zeros(G, ncols)))
            synchronize(dev)
            t1 = time.perf_counter()
            if not chunk_meta or total == 0:
                return (np.array([], dtype=object),
                        np.zeros((0, c.vector_size), np.int32),
                        np.zeros((0, ncols), np.int32))
            if agg is not None:
                agg.finish()
                agg.finalize_bins()
                sorted_windows = agg.n_entries

                def bins_at(bi, off, kw):
                    return agg.batch_bins(bi)[:kw]
            elif spill:
                bins_host = self._chunked_sortjoin_bins(keys_parts,
                                                        weighted=weighted)
                ranges = self._last_ranges
                sorted_windows = total
                del keys_parts

                def bins_at(bi, off, kw):
                    return self._to_device(bins_host[off:off + kw])
            else:
                npad = self._sortjoin_pad_size(local)
                if npad > local:
                    keys_parts.append(self._pad_part(npad - local, weighted))
                cols = [torch.cat([p[i] for p in keys_parts])
                        for i in range(len(keys_parts[0]))]
                del keys_parts
                bins = self._bins(cols[0], cols[1] if weighted else None)
                del cols
                sorted_windows = npad

                def bins_at(bi, off, kw):
                    return bins[off:off + kw]
            synchronize(dev)
            t2 = time.perf_counter()
            names: List[str] = []
            abd_dev, tnf_dev = [], []
            off = 0
            bi = 0
            for cnames, segs, thist in chunk_meta:
                hist = self._zeros(G, c.vector_size)
                for seg, kept_rows in segs:
                    kw = kept_rows * wrow
                    abundance_histogram_from_bins(
                        hist, bins_at(bi, off, kw).view(kept_rows, wrow),
                        seg, vector_size=c.vector_size)
                    off += kw
                    bi += 1
                names += list(cnames)
                g = len(cnames)
                abd_dev.append(hist[:g])
                tnf_dev.append(thist[:g])
            abd_all = self._reduce(torch.cat(abd_dev)).cpu().numpy()
            tnf_all = self._reduce(torch.cat(tnf_dev)).cpu().numpy()
            t3 = time.perf_counter()
        finally:
            if agg is not None:
                agg.cleanup()
        self.stats = {"path": "sortjoin", "windows": total,
                      "sorted_windows": sorted_windows,
                      "batches": sum(len(m[1]) for m in chunk_meta),
                      "chunks": len(chunk_meta), "io": io,
                      "spill": "agg" if agg is not None
                      else "raw" if spill else "none",
                      "store": agg.store if agg is not None
                      else "host" if spill else "device",
                      "spill_chunks": len(agg.groups) if agg is not None
                      else 0,
                      "ranges": ranges,
                      "stream_s": t1 - t0, "sortjoin_s": t2 - t1,
                      "replay_s": t3 - t2}
        log.info("sortjoin done: %d barcodes, %d windows (spill %s)",
                 len(names), total, self.stats["spill"])
        if not names:
            return (np.array([], dtype=object),
                    np.zeros((0, c.vector_size), np.int32),
                    np.zeros((0, ncols), np.int32))
        return np.array(names), abd_all, tnf_all

    def _chunked_sortjoin_bins(self, host_parts: List[Tuple[np.ndarray, ...]],
                               weighted: bool = False) -> np.ndarray:
        """Exact sort-join over host-resident keys, one key-VALUE range at
        a time, each range within the device window cap.

        Partitioning by key value means equal keys always share a range,
        so per-range joins are independent and exact — no cross-range
        merge. Range boundaries come from quantiles of a <= 1M-key
        sample, so ranges balance even though canonical-key density is 2x
        mean at the low end of the key space. A hot key with more
        instances than the cap cannot be split (its range just runs
        larger, with a warning) — the join is still exact.

        Returns per-window abundance bins in stream order (-1 = invalid
        or out of range), matching :func:`sortjoin_bins`. With
        ``weighted`` each part is (keys, weights) and the join is
        :func:`sortjoin_bins_weighted`; weights ride the partition, so
        per-range weight sums stay exact. Sets ``_last_ranges`` to the
        number of ranges joined.

        Split over devices (the sharded extractor), the valid-key count
        and the range counts are summed and the sample gathered over
        them, so every device joins the same ranges, each through the
        collective join, even a range it holds no key of."""
        c = self.cfg
        sent = kmer_key_sentinel(c.kmer)
        v = np.concatenate([p[0] for p in host_parts])
        w_all = (np.concatenate([p[1] for p in host_parts])
                 if weighted else None)
        N = v.shape[0]
        bins_all = np.full(N, -1, np.int32)
        self._last_ranges = 0
        valid = v < sent
        nval = int(self._reduce(torch.tensor([int(valid.sum())],
                                             device=self.device)))
        if nval == 0:
            return bins_all
        cap = self._sortjoin_window_cap()
        # 5% headroom so quantile jitter rarely pushes a range past the cap
        nparts = max(1, -(-nval // max(1, cap * 19 // 20)))
        if nparts > 1:
            # stride BEFORE masking: v[valid] would copy every valid key
            # just to stride them away
            step = max(1, N // 1_000_000)
            vs = v[::step]
            sample = np.sort(self._to_host(self._gather(
                self._to_device(vs[vs < sent]))))
            qpos = (np.arange(1, nparts) * len(sample)) // nparts
            bounds = np.unique(sample[qpos])
        else:
            bounds = np.empty(0, v.dtype)
        inval_digit = len(bounds) + 1
        dt = np.uint8 if inval_digit < 255 else np.int32
        digits = np.searchsorted(bounds, v, side="right").astype(dt)
        digits[~valid] = inval_digit
        counts = self._to_host(self._reduce(self._to_device(np.bincount(
            digits, minlength=inval_digit + 1)[:inval_digit])))
        if counts.max() > cap:
            log.warning("chunked sort-join: a key range holds %d windows > "
                        "cap %d (hot keys cannot split across ranges); "
                        "running one larger sort", int(counts.max()), cap)
        # Two-deep pipeline: range p+1's host gather and upload are issued
        # before range p's bins are copied back, so host work overlaps
        # the device sorts (the joins are independent).
        pending = None  # (idx, device bins)
        for p in range(len(counts)):
            # one flatnonzero scan per range, not an argsort of all digits
            if counts[p] == 0:
                continue
            idx = np.flatnonzero(digits == p)
            keys = self._to_device(v[idx])
            wts = self._to_device(w_all[idx]) if weighted else None
            dev_bins = self._bins(keys, wts)
            del keys, wts
            if pending is not None:
                bins_all[pending[0]] = self._to_host(pending[1])
            pending = (idx, dev_bins)
            self._last_ranges += 1
            log.info("chunked sort-join: range %d/%d (%d windows)",
                     self._last_ranges, int((counts > 0).sum()),
                     int(idx.size))
        if pending is not None:
            bins_all[pending[0]] = self._to_host(pending[1])
        return bins_all

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    # ---- dense-table paths (k <= 15) --------------------------------------

    def global_kmer_table(self, reads1: str = "", reads2: str = "",
                          interleaved: str = "") -> torch.Tensor:
        """The global pass: every read of the input file(s) counted into
        a (4^k,) int32 table on the device (jellyfish count). Paired
        input is quality-masked by the reader (``min_qual_char``, as
        pangaea_tpu's global pass does whenever both mates are given);
        interleaved input wins when both forms are given."""
        c = self.cfg
        table = make_global_table(c.kmer, self.device)
        for codes, lengths, _, cont in self._global_batches(
                reads1, reads2, interleaved):
            count_kmers_global(table, codes, lengths, cont, k=c.kmer,
                               overlap=c.kmer - 1)
        return table

    def _global_batches(self, reads1: str, reads2: str, interleaved: str):
        """The global pass's device batches (codes, lengths, seg_ids,
        cont): every read of the input file(s) through the native
        reader, quality-masked on paired input."""
        c = self.cfg
        paths = [interleaved] if interleaved else [reads1, reads2]
        mq = c.min_qual_char if (reads1 and reads2) else None
        batches = native_seq_batches(paths, self.row_len, c.reads_per_batch,
                                     min_qual_char=mq)
        events = (("batch", b) for b in batches)
        for _, (_, host) in prefetch(self._host_tensors(events), depth=4):
            yield self._device_batch(host)

    def group_features(self, table: torch.Tensor, reads1: str = "",
                       reads2: str = "", interleaved: str = "") -> Features:
        """The group pass against a global count table: per barcode, the
        abundance histogram (each window's count looked up in ``table``)
        and the TNF counts, in one stream. It reuses the sort-join's
        group stream, whose dropped groups and mismatched pairs arrive as
        seg -1 rows and fall out of both histograms (pangaea_tpu's table
        pass leaves them out of its stream instead)."""
        c = self.cfg
        overlap = c.kmer - 1
        ncols = num_canonical_kmers(c.tnf_kmer)
        lut = rank_lut_tensor(c.tnf_kmer, self.device)
        G = self.groups_per_chunk
        _, events = self._group_events(reads1, reads2, interleaved)
        names: List[str] = []
        abd_dev, tnf_dev = [], []
        hist, thist = self._zeros(G, c.vector_size), self._zeros(G, ncols)
        for kind, payload in prefetch(self._host_tensors(events), depth=4):
            if kind == "chunk":
                g = len(payload)
                names += list(payload)
                abd_dev.append(hist[:g])
                tnf_dev.append(thist[:g])
                hist = self._zeros(G, c.vector_size)
                thist = self._zeros(G, ncols)
                continue
            codes, lengths, seg, cont, *_ = self._device_batch(payload[1])
            abundance_histogram(hist, table, codes, lengths, seg, cont,
                                k=c.kmer, window=c.window_size,
                                vector_size=c.vector_size, overlap=overlap)
            tnf_histogram_segsum(thist, codes, lengths, seg, cont,
                                 k=c.tnf_kmer, overlap=overlap, rank_lut=lut)
        if not names:
            return (np.array([], dtype=object),
                    np.zeros((0, c.vector_size), np.int32),
                    np.zeros((0, ncols), np.int32))
        return (np.array(names),
                self._reduce(torch.cat(abd_dev)).cpu().numpy(),
                self._reduce(torch.cat(tnf_dev)).cpu().numpy())

    def _table_features(self, reads1: str, reads2: str,
                        interleaved: str) -> Features:
        t0 = time.perf_counter()
        table = self.global_kmer_table(reads1, reads2, interleaved)
        synchronize(self.device)
        t1 = time.perf_counter()
        out = self.group_features(table, reads1, reads2, interleaved)
        del table
        self.stats = {"path": "table", "global_s": t1 - t0,
                      "group_s": time.perf_counter() - t1}
        return out

    # ---- jellyfish dump interchange ---------------------------------------

    def export_jellyfish_dump(self, table: torch.Tensor, path: str) -> int:
        """Write a global table as a jellyfish ``dump -c -t`` file
        (``KMER\\tCOUNT`` lines, counts >= 1, ascending k-mer value) — the
        interchange format of the reference's count_kmer
        (src/feature.py:87,101-103). Returns the number of lines."""
        t = table.cpu().numpy()
        nz = np.flatnonzero(t)
        strs = decode_kmers(nz, self.cfg.kmer)
        with open(path, "w") as f:
            f.writelines(f"{s.decode()}\t{int(n)}\n"
                         for s, n in zip(strs, t[nz]))
        return len(nz)

    def import_jellyfish_dump(self, path: str) -> torch.Tensor:
        """Load a jellyfish ``dump -c -t`` file (plain or .gz) into a
        dense count table on the extractor's device — count_kmer's ``-g``
        input (count_kmer.cpp:139-170). Each k-mer string is
        re-canonicalized, so dumps of either strand convention load, and
        the counts of k-mers that canonicalize alike add up. Use with
        :meth:`group_features` to bin against externally computed global
        counts (k <= 15)."""
        k = self.cfg.kmer
        table = make_global_table(k, "cpu").numpy()
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            fields = [line.split() for line in f]
        bad = [m for m, _ in fields if len(m) != k]
        if bad:
            raise ValueError(f"dump k-mer '{bad[0]}' length {len(bad[0])} "
                             f"!= k={k}")
        if fields:
            mers = "".join(m for m, _ in fields).upper().encode("ascii")
            codes = encode_bases(mers).reshape(-1, k).astype(np.uint32)
            v = np.zeros(len(fields), np.uint32)
            for j in range(k):
                v = (v << np.uint32(2)) | codes[:, j]
            canon = np.minimum(v, revcomp_kmers_np(v, k)).astype(np.int64)
            np.add.at(table, canon,
                      np.array([int(n) for _, n in fields], np.int32))
        return torch.from_numpy(table).to(self.device)

    # ---- artifacts --------------------------------------------------------

    @staticmethod
    def _write_csv_gz(path: str, names: np.ndarray, mat: np.ndarray) -> None:
        """The reference tools' gzipped CSV (name,c0,c1,...) at gzip level
        1 (parity is on the decompressed bytes). Python's csv writer with
        minimal quoting — the writer under pangaea_tpu's ``to_csv`` — so
        the bytes are the same.

        Written through :func:`replacing` (a unique temp name, then
        rename), unlike pangaea_tpu's fixed ``path + '.tmp'``."""
        rows = [[n, *r] for n, r in zip(np.asarray(names).tolist(),
                                        np.asarray(mat).tolist())]
        with replacing(path) as tmp:
            with gzip.open(tmp, "wt", compresslevel=1, newline="") as f:
                csv.writer(f, lineterminator="\n").writerows(rows)

    @staticmethod
    def _read_csv_gz(path: str) -> Tuple[np.ndarray, np.ndarray]:
        """Inverse of :meth:`_write_csv_gz`: names verbatim (no numeric
        or NA conversion) and an int32 matrix."""
        with gzip.open(path, "rt", newline="") as f:
            rows = list(csv.reader(f))
        names = np.array([r[0] for r in rows], dtype=str)
        ncols = len(rows[0]) - 1 if rows else 0
        mat = np.array([r[1:] for r in rows], dtype=np.int64)
        return names, mat.reshape(len(rows), ncols).astype(np.int32)

    def _save(self, names, abd, tnf) -> None:
        """Only the gz CSVs — what the reference's count_kmer / count_tnf
        binaries emit — then the marker, after both files landed."""
        self._write_csv_gz(self.abd_gz, names, abd)
        self._write_csv_gz(self.tnf_gz, names, tnf)
        with open(self.marker, "w") as f:
            f.write("feature finished")

    def _extract_inner(self, reads1: str, reads2: str,
                       interleaved: str) -> Features:
        c = self.cfg
        if not (interleaved or (reads1 and reads2)):
            raise ValueError("reads must be specified")
        if not 1 <= c.kmer <= 31:
            raise ValueError(f"k={c.kmer}: the k-mer length must be 1..31 "
                             "(the reference's uint64 k-mers)")
        if c.hist_impl not in ("auto", "sortjoin", "scatter", "segsum"):
            raise ValueError(f"unknown hist_impl {c.hist_impl!r}")
        if self.sortjoin_eligible(reads1, reads2, interleaved):
            return self.group_features_sortjoin(reads1, reads2, interleaved)
        if c.kmer > 15:
            # pangaea_tpu/features.py:1581-1590
            raise ValueError(
                f"k={c.kmer} > 15 requires the sort-join path: pass "
                "hist_impl='auto'/'sortjoin' (the dense table only "
                "exists for k <= 15)")
        return self._table_features(reads1, reads2, interleaved)

    def extract_features(self, reads1: str = "", reads2: str = "",
                         interleaved: str = "", defer_save: bool = False
                         ) -> Features:
        """Features of every kept barcode: (names, abundance, tnf).

        ``defer_save=True`` moves the artifact write (two gzip CSVs + the
        ``feature_finished`` marker) onto a background thread so it
        overlaps the next pipeline step. The marker is written only AFTER
        both files land (a crash mid-save re-runs step 1), and the caller
        must invoke :meth:`wait_save` before relying on the artifacts."""
        if self._features_exist():
            log.info("features already extracted, loading")
            return self.load_features()
        self._rl = (self._auto_row_len(reads1, reads2, interleaved)
                    if self.cfg.auto_row_len else None)
        try:
            names, abd, tnf = self._extract_inner(reads1, reads2,
                                                  interleaved)
        except OverlongReadError as e:
            if self._rl is None:
                raise
            # a read longer than the sampled maximum appeared on the
            # native path (the Python packer would have split it): retry
            # once at the configured width
            log.warning("auto row length %d too small (%s); retrying at "
                        "max_read_len=%d", self._rl, e,
                        self.cfg.max_read_len)
            self._rl = None
            names, abd, tnf = self._extract_inner(reads1, reads2,
                                                  interleaved)
        if defer_save:
            pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            self._pending_save = pool.submit(self._save, names, abd, tnf)
            pool.shutdown(wait=False)
        else:
            self._save(names, abd, tnf)
        return names, abd, tnf

    def _features_exist(self) -> bool:
        return os.path.exists(self.abd_gz) and os.path.exists(self.tnf_gz)

    def wait_save(self) -> None:
        """Join a ``defer_save`` background write; re-raises its error
        (the marker is then absent, so a re-run redoes step 1)."""
        pending, self._pending_save = self._pending_save, None
        if pending is not None:
            pending.result()

    def load_features(self) -> Features:
        """(names, abundance, tnf) from the step-1 CSVs."""
        names, abd = self._read_csv_gz(self.abd_gz)
        names_t, tnf = self._read_csv_gz(self.tnf_gz)
        if not (names == names_t).all():  # src/feature.py:35 invariant
            raise ValueError("abundance and TNF barcodes disagree")
        return names, abd, tnf
