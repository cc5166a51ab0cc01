"""Multi-process input sharding + cross-process reductions.

Port of pangaea_tpu/parallel/multihost.py. Per-process input pipelines
read disjoint FASTQ shards whose boundaries respect barcode groups (the
stream is barcode-sorted, so splitting at group boundaries keeps every
barcode in one process), and per-process partial results merge with
collectives:

- global k-mer table: per-process partial table -> all_reduce sum;
- per-barcode features: disjoint by construction (no merge needed);
- latent gather before clustering: :func:`allgather_rows`.

The split is host code, copied from pangaea_tpu. The reductions run on
the default ``torch.distributed`` group and are no-ops with one process,
as pangaea_tpu's are.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from pangaea_tpu_torch.parallel.mesh import check_backend, world_size

log = logging.getLogger(__name__)


def _iter_raw_chunks(path: str, chunk_size: int):
    """Yield (decompressed_chunk, raw_bytes_consumed_so_far). Gzip input
    inflates via zlib.decompressobj (handles multi-member pigz/bgzf
    files); the consumed counter is in *compressed* bytes so shard
    balancing works without knowing the decompressed total."""
    import zlib
    gz = path.endswith((".gz", ".bgz"))
    with open(path, "rb") as f:
        consumed = 0
        if not gz:
            while True:
                chunk = f.read(chunk_size)
                if not chunk:
                    return
                consumed += len(chunk)
                yield chunk, consumed
        d = zlib.decompressobj(wbits=31)
        while True:
            raw = f.read(chunk_size)
            if not raw:
                return
            consumed += len(raw)
            out = d.decompress(raw)
            while d.eof and d.unused_data:  # next gzip member
                tail = d.unused_data
                d = zlib.decompressobj(wbits=31)
                try:
                    out += d.decompress(tail)
                except zlib.error:
                    # trailing non-gzip bytes after the last member
                    # (padding/garbage some tools append — gzip itself
                    # only warns); treat as end of stream
                    d = zlib.decompressobj(wbits=31)
                    break
            if out:
                yield out, consumed


class _ShardWriter:
    """Shard output file; with compress=True, gzip level-1 compression
    runs on a dedicated thread (zlib releases the GIL, so the n_shards
    compressors and the reader genuinely overlap)."""

    def __init__(self, path: str, compress: bool):
        self.path = path + ".gz" if compress else path
        self._f = open(self.path, "wb")
        self._q = None
        self._err = None
        if compress:
            import queue
            import threading
            self._q = queue.Queue(maxsize=8)
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

    def _run(self):
        import zlib
        try:
            comp = zlib.compressobj(1, zlib.DEFLATED, 31)
            while True:
                block = self._q.get()
                if block is None:
                    self._f.write(comp.flush())
                    return
                out = comp.compress(block)
                if out:
                    self._f.write(out)
        except Exception as e:  # surfaced by write()/close(): a dead
            self._err = e       # thread must not leave the producer
            while True:         # blocked on a full queue (e.g. ENOSPC)
                if self._q.get() is None:
                    return

    def _check(self):
        if self._err is not None:
            raise self._err

    def write(self, block: bytes):
        if self._q is not None:
            self._check()
            self._q.put(block)
        else:
            self._f.write(block)

    def close(self):
        if self._q is not None:
            self._q.put(None)
            self._t.join()
        self._f.close()
        self._check()


def split_interleaved_by_barcode(path: str, out_prefix: str,
                                 n_shards: int, compress: bool = None,
                                 chunk_size: int = 8 << 20) -> List[str]:
    """Split a barcode-sorted interleaved FASTQ into n shards at barcode
    boundaries (approximately byte-balanced). Returns shard paths.

    Byte-chunked, not per-record: away from shard boundaries, 8 MiB
    blocks stream straight from the inflater to the output (only a
    newline count per block); records are parsed only in the boundary
    regions while hunting for the next barcode change. Balancing
    thresholds are in *input* bytes (compressed for .gz), so gzip input
    balances without knowing the decompressed size. ``compress=None``
    matches the input (gzip in -> level-1 gzip shards, each on its own
    compressor thread).

    The reference's boundary leak moves the first pair of each barcode
    into the previous group, so a split at a barcode boundary keeps even
    the leaked pair on one shard; feature counts are additive either way
    because groups never span shards.
    """
    from pangaea_tpu_torch.io.fastq import BarcodeParser
    parser = BarcodeParser()
    if compress is None:
        compress = path.endswith((".gz", ".bgz"))
    total_raw = os.path.getsize(path)
    writers = [_ShardWriter(f"{out_prefix}.shard{i}.fq", compress)
               for i in range(n_shards)]
    cur = 0
    phase = 0        # newlines into the current 8-line pair block
    scanning = False
    baseline = None  # barcode of the first pair seen in this scan
    carry = b""      # undecided tail: an incomplete pair block

    def cutoff(i: int) -> int:
        return total_raw * (i + 1) // n_shards

    try:
        consumed = 0
        for chunk, consumed in _iter_raw_chunks(path, chunk_size):
            if not scanning:
                if cur == n_shards - 1 or consumed <= cutoff(cur):
                    # bulk: the whole chunk belongs to the current shard
                    writers[cur].write(chunk)
                    phase = (phase + chunk.count(b"\n")) % 8
                    continue
                scanning = True
            buf = carry + chunk
            carry = b""
            pos = 0
            # finish the pair block in flight (it predates the scan)
            while phase and pos < len(buf):
                nl = buf.find(b"\n", pos)
                if nl == -1:
                    writers[cur].write(buf[pos:])
                    pos = len(buf)
                    break
                writers[cur].write(buf[pos:nl + 1])
                pos = nl + 1
                phase = (phase + 1) % 8
            # parse whole pair blocks until the barcode changes
            while scanning and pos < len(buf):
                end = pos
                complete = True
                for _ in range(8):
                    nl = buf.find(b"\n", end)
                    if nl == -1:
                        complete = False
                        break
                    end = nl + 1
                if not complete:
                    carry = buf[pos:]
                    pos = len(buf)
                    break
                header = buf[pos:buf.find(b"\n", pos)]
                _, bc = parser.parse(
                    header.decode("ascii", "replace").lstrip("@"))
                if baseline is None:
                    baseline = bc
                if bc != baseline:
                    cur += 1
                    baseline = None
                    if cur == n_shards - 1 or consumed <= cutoff(cur):
                        scanning = False  # back to bulk for the rest
                writers[cur].write(buf[pos:end])
                pos = end
            if not scanning and pos < len(buf):
                rest = buf[pos:]
                writers[cur].write(rest)
                phase = rest.count(b"\n") % 8
        if carry:  # incomplete trailing record — emit as-is
            writers[cur].write(carry)
    finally:
        for w in writers:
            w.close()
    return [w.path for w in writers]


def allreduce_table(table: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """Sum per-process partial k-mer tables (an int32 ``all_reduce``
    sum, in place, on the table's device). No-op with one process."""
    if world_size(group) == 1:
        return table
    check_backend(group or dist.group.WORLD, table.device)
    dist.all_reduce(table, op=dist.ReduceOp.SUM, group=group)
    return table


def gather_rows(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Concatenation of every rank's row block ``t`` in rank order, on
    ``t``'s device. Blocks may be RAGGED, so the row counts are gathered
    first, each block is padded to the largest, gathered, and trimmed."""
    n = dist.get_world_size(group)
    count = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [torch.empty_like(count) for _ in range(n)]
    dist.all_gather(counts, count, group=group)
    counts = [int(c) for c in counts]
    block = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
    block[:t.shape[0]] = t
    gathered = [torch.empty_like(block) for _ in range(n)]
    dist.all_gather(gathered, block, group=group)
    return torch.cat([b[:c] for b, c in zip(gathered, counts)])


def allgather_rows(local: np.ndarray,
                   group: Optional[dist.ProcessGroup] = None,
                   device=None) -> np.ndarray:
    """Concatenate per-process row blocks in rank order (the latent
    gather before clustering; blocks may be ragged, as processes hold
    different barcode counts). The gather runs on ``device`` (``cuda``
    on an NCCL group, ``cpu`` on gloo; by default the one the group's
    backend takes). No-op with one process."""
    local = np.ascontiguousarray(local)
    if world_size(group) == 1:
        return local
    g = group or dist.group.WORLD
    if device is None:
        device = ("cuda" if str(dist.get_backend(g)).lower() == "nccl"
                  else "cpu")
    dev = torch.device(device)
    check_backend(g, dev)
    return gather_rows(torch.from_numpy(local).to(dev), g).cpu().numpy()
