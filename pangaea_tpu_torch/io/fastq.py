"""FASTQ streaming, linked-read barcode extraction and the step-0
barcode sort.

Host-side input layer, copied from pangaea_tpu.io.fastq. The barcode
parsing rules reproduce ``getBarcode`` in the reference C++ tools
(count_kmer.cpp:23-53, count_tnf.cpp:22-52, extract_reads.cpp:9-39):

- read type is inferred once, stickily, from the first header that matches:
  a header containing ``BX:Z`` => "10x" (also Tell-Seq after preprocessing);
  otherwise a header containing ``#`` => "stLFR".
- 10x: read name = header up to first whitespace; barcode = substring after
  ``BX:Z:`` up to the first ``-``.
- stLFR: read name = header before ``#``; barcode = between ``#`` and ``/``;
  barcode ``0_0_0`` means "no barcode" and becomes empty.
"""

from __future__ import annotations

import gzip
import io
import logging
import os
import re
import shutil
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

log = logging.getLogger(__name__)


def open_maybe_gzip(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        if "t" in mode:
            return io.TextIOWrapper(gzip.open(path, mode.replace("t", "b")),
                                    encoding="ascii", newline="\n")
        return gzip.open(path, mode)
    return open(path, mode)


@dataclass
class FastqRecord:
    header: str   # without leading '@'
    seq: str
    qual: str


class BarcodeParser:
    """Sticky read-type inference + barcode extraction (count_kmer.cpp:25-53)."""

    def __init__(self, read_type: str = ""):
        self.read_type = read_type  # "", "10x", or "stLFR"

    def parse(self, header: str) -> Tuple[str, str]:
        """header is the '@'-stripped FASTQ header line.

        Returns (read_name, barcode); barcode == "" means unbarcoded.
        """
        if not self.read_type:
            if "BX:Z" in header:
                self.read_type = "10x"
            elif "#" in header:
                self.read_type = "stLFR"
        if self.read_type == "stLFR":
            pos1 = header.find("#")
            pos2 = header.find("/", pos1 + 1)
            name = header[:pos1]
            barcode = header[pos1 + 1: pos2 if pos2 != -1 else len(header)]
            if barcode == "0_0_0":
                barcode = ""
            return name, barcode
        # 10x / Tell-Seq (or not-yet-inferred): name up to whitespace
        end = len(header)
        for ch in " \r\t\n":
            p = header.find(ch)
            if p != -1 and p < end:
                end = p
        name = header[:end]
        barcode = ""
        pos1 = header.find("BX:Z")
        if pos1 != -1:
            pos2 = header.find("-", pos1 + 5)
            barcode = header[pos1 + 5: pos2 if pos2 != -1 else len(header)]
        return name, barcode


def iter_fastq_records(path_or_handle) -> Iterator[FastqRecord]:
    if not isinstance(path_or_handle, str):
        yield from _iter_records(path_or_handle)
        return
    with open_maybe_gzip(path_or_handle) as handle:
        yield from _iter_records(handle)


def _iter_records(handle) -> Iterator[FastqRecord]:
    it = iter(handle)
    for header in it:
        try:
            seq = next(it).rstrip("\n")
            next(it)  # '+'
            qual = next(it).rstrip("\n")
        except StopIteration:
            # truncated final record: drop it with a warning instead of
            # the opaque PEP 479 RuntimeError
            log.warning("truncated FASTQ record at EOF dropped (%r...)",
                        header[:40])
            return
        yield FastqRecord(header.rstrip("\n").lstrip("@"), seq, qual)


def iter_interleaved_pairs(path: str) -> Iterator[Tuple[FastqRecord, FastqRecord]]:
    """Yield (R1, R2) record pairs from an interleaved FASTQ. A trailing
    unpaired record is dropped (count_kmer's interleaved loop reads two
    records per iteration and stops when the second getline fails,
    count_kmer.cpp:246-252)."""
    it = iter_fastq_records(path)
    while True:
        try:
            r1 = next(it)
        except StopIteration:
            return
        try:
            r2 = next(it)
        except StopIteration:
            log.warning("odd record count: trailing unpaired read %r dropped",
                        r1.header[:40])
            return
        yield r1, r2


def iter_paired_pairs(path1: str, path2: str
                      ) -> Iterator[Tuple[FastqRecord, FastqRecord]]:
    """Yield (R1, R2) record pairs from two files read in lockstep; reads
    of reads1 past the end of reads2 are dropped with a warning."""
    it1, it2 = iter_fastq_records(path1), iter_fastq_records(path2)
    for r1 in it1:
        try:
            r2 = next(it2)
        except StopIteration:
            log.warning("reads2 ended before reads1; trailing reads dropped")
            return
        yield r1, r2


# * not +: a bare "BX:Z:" token (empty barcode) must key as
# "BX:Z:", exactly like the native scanners, not as unbarcoded
_BX_RX = re.compile(rb"BX:Z:[^ \t\r\n]*")


def _iter_sort_lines(in_path: str):
    """Yield one NUL-joined bytes line per 8-line record:
    ``tag\\x00l1\\x00...\\x00l8``. NUL is below every printable FASTQ
    byte, so comparing whole joined lines bytewise (LANG=C) equals
    comparing the (tag, l1, ..., l8) tuple lexicographically — the sort
    order of the reference's ``LANG=C sort -k1,1`` with its whole-line
    tie-break (src/run_pangaea:237-252). Bulk chunk splits, not per-line
    iteration: this conversion is the sort's host bottleneck."""
    opener = (gzip.open(in_path, "rb") if str(in_path).endswith(".gz")
              else open(in_path, "rb"))
    nul = b"\x00"
    with opener as f:
        carry = b""
        lines_buf: list = []
        while True:
            data = f.read(8 << 20)
            if not data:
                break
            parts = (carry + data).split(b"\n")
            carry = parts.pop()
            lines_buf.extend(parts)
            n8 = (len(lines_buf) // 8) * 8
            for i in range(0, n8, 8):
                m = _BX_RX.search(lines_buf[i])
                tag = m.group(0) if m else b"~~~"
                yield tag + nul + nul.join(lines_buf[i:i + 8])
            del lines_buf[:n8]
        if carry:
            # no trailing newline: the carry is still the final line —
            # dropping it would lose the last record (native readers
            # keep it)
            lines_buf.append(carry)
        if len(lines_buf) >= 8:
            m = _BX_RX.search(lines_buf[0])
            tag = m.group(0) if m else b"~~~"
            yield tag + nul + nul.join(lines_buf[:8])
        # a genuinely partial trailing record (fewer than 8 lines) is
        # dropped, like the reference's awk block loop


def _emit_record(line: bytes) -> bytes:
    return line[line.index(b"\x00") + 1:].replace(b"\x00", b"\n") + b"\n"


def _open_out(out_path: str):
    return (gzip.open(out_path, "wb", compresslevel=1)
            if str(out_path).endswith(".gz") else
            open(out_path, "wb", buffering=1 << 20))


def barcode_sort_interleaved(in_path: str, out_path: str,
                             mem_limit: int = 512 << 20,
                             tmp_dir: Optional[str] = None,
                             backend: str = "auto") -> None:
    """Sort an interleaved FASTQ by barcode tag, unbarcoded last — as an
    EXTERNAL sort, so step 0 handles genome-scale files in bounded
    memory exactly like the reference's disk-backed ``LANG=C sort``
    (src/run_pangaea:237-252).

    Three backends, identical output bytes; ``auto`` picks 'native' for
    plain output, else 'gnu' when ``sort`` is on PATH, else 'python':

    - 'native' (plain output only): C++ external MSD radix sort — one
      streaming scatter pass into byte-range bucket files, then
      in-memory per-bucket sorts (each bucket ~1/256th of the data). Two
      sequential IO passes against GNU sort's ~four. When it fails
      (more open buckets than its cap), GNU sort runs instead, with a
      warning.
    - 'gnu': stream NUL-joined record lines through ``LANG=C sort
      -S<mem> -T<tmp>`` — the very tool the reference uses, with its
      run spilling and multi-way merge; the native library converts the
      records both ways (the Python writer emits gzipped output).
    - 'python': dependency-free (sorted run files + heapq k-way merge).

    Order reproduced from the reference awk | sort pipeline: the key is
    the literal ``BX:Z:<barcode>`` token (``~~~`` when absent), ties
    fall back to whole-record byte order (GNU sort without -s compares
    the full line last). Divergence kept from r1: the reference joins
    record lines with tabs and ``tr``s every tab back to newline,
    corrupting headers that contain a tab before the BX:Z tag (e.g.
    preprocess_stlfr output); here records travel as intact 8-line
    blocks.
    """
    if backend == "auto":
        if not str(out_path).endswith(".gz"):
            backend = "native"   # built at first use; a failed build raises
        elif shutil.which("sort"):
            backend = "gnu"
        else:
            backend = "python"
    if backend == "native":
        from pangaea_tpu_torch.native import get_lib
        get_lib()  # a failed build raises here, before the GNU retry
        try:
            _native_barcode_sort(in_path, out_path, mem_limit, tmp_dir)
            return
        except RuntimeError as e:
            # e.g. an adversarial header alphabet exceeding the open-
            # bucket cap: GNU sort handles anything
            log.warning("native radix sort failed (%s); falling back to "
                        "GNU sort", e)
            backend = "gnu"
    if backend == "gnu":
        _gnu_barcode_sort(in_path, out_path, mem_limit, tmp_dir)
    else:
        _python_barcode_sort(in_path, out_path, mem_limit, tmp_dir)


def _native_barcode_sort(in_path: str, out_path: str, mem_limit: int,
                         tmp_dir: Optional[str]) -> None:
    import tempfile
    from pangaea_tpu_torch.native import get_lib
    if str(out_path).endswith(".gz"):
        raise ValueError("backend='native' writes plain FASTQ only; "
                         "use backend='gnu'/'python' for .gz output")
    lib = get_lib()
    with tempfile.TemporaryDirectory(prefix="bcsort_", dir=tmp_dir) as td:
        n = lib.pgn_sort_radix(str(in_path).encode(),
                               str(out_path).encode(), td.encode(),
                               mem_limit)
        if n < 0:
            raise RuntimeError("native radix barcode sort failed")


def _gnu_barcode_sort(in_path: str, out_path: str, mem_limit: int,
                      tmp_dir: Optional[str]) -> None:
    import subprocess
    import tempfile
    import threading
    from pangaea_tpu_torch.native import get_lib

    with tempfile.TemporaryDirectory(prefix="bcsort_",
                                     dir=tmp_dir) as td:
        env = dict(os.environ, LANG="C", LC_ALL="C")
        # --parallel: GNU sort's run-sorting and merge threads; the
        # python conversion threads are IO/GIL-light by comparison
        proc = subprocess.Popen(
            ["sort", f"-S{max(16, mem_limit >> 20)}M", "-T", td,
             f"--parallel={os.cpu_count() or 2}"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        err: list = []
        # the native converters (C++ at parse speed, the GIL released):
        # Python conversion is the pipeline's bottleneck both ways; only
        # gzipped output needs the Python writer
        native = get_lib()

        def feed():
            try:
                n = native.pgn_sort_feed(str(in_path).encode(),
                                         proc.stdin.fileno())
                if n < 0:
                    raise RuntimeError("native sort feed failed")
            except BaseException as e:  # noqa: BLE001 — raised below
                err.append(e)
                proc.kill()
            finally:
                try:
                    proc.stdin.close()
                except OSError:
                    pass

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        if not str(out_path).endswith(".gz"):
            n = native.pgn_sort_emit(proc.stdout.fileno(),
                                     str(out_path).encode())
            if n < 0:
                proc.kill()
                t.join()
                proc.wait()
                raise RuntimeError("native sort emit failed")
        else:
            with _open_out(out_path) as out:
                buf = bytearray()
                while True:
                    data = proc.stdout.read(1 << 20)
                    if not data:
                        break
                    buf += data
                    lines = bytes(buf).split(b"\n")
                    buf = bytearray(lines.pop())
                    out.write(b"".join(_emit_record(ln) for ln in lines))
                if buf:
                    out.write(_emit_record(bytes(buf)))
        t.join()
        rc = proc.wait()
        if err:
            raise err[0]
        if rc:
            raise RuntimeError(f"sort exited {rc}")


def _python_barcode_sort(in_path: str, out_path: str, mem_limit: int,
                         tmp_dir: Optional[str]) -> None:
    import heapq
    import tempfile

    run_dir = None
    run_paths: list = []
    buf: list = []
    size = 0

    def flush_run():
        nonlocal run_dir, buf, size
        if not buf:
            return
        if run_dir is None:
            run_dir = tempfile.mkdtemp(prefix="bcsort_", dir=tmp_dir)
        buf.sort()
        path = os.path.join(run_dir, f"run{len(run_paths)}")
        with open(path, "wb") as f:
            f.write(b"\n".join(buf) + b"\n")
        run_paths.append(path)
        buf = []
        size = 0

    try:
        for line in _iter_sort_lines(in_path):
            buf.append(line)
            size += len(line) + 57  # ~CPython bytes-object overhead
            if size >= mem_limit:
                flush_run()
        with _open_out(out_path) as out:
            if not run_paths:  # fits in memory: sort in place
                buf.sort()
                for line in buf:
                    out.write(_emit_record(line))
                return
            flush_run()

            def run_lines(path):
                with open(path, "rb") as f:
                    for raw in f:
                        yield raw[:-1]

            for line in heapq.merge(*(run_lines(p) for p in run_paths)):
                out.write(_emit_record(line))
    finally:
        if run_dir is not None:
            shutil.rmtree(run_dir, ignore_errors=True)
