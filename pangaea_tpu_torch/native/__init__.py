"""The native FASTQ reader: C++ gzip streaming, FASTQ parsing, barcode
extraction and 2-bit encoding in bulk, bound with ctypes.

``fastq_reader.cpp`` is a copy of pangaea_tpu's native reader with one
repair: a gzip input that is truncated (it ends inside a member) or
corrupt (a bad deflate block, header, CRC or length) is an error, where
pangaea_tpu's copy reads it as a short file. :meth:`NativeFastqReader.read`
raises ``EOFError`` for the first and :class:`CorruptGzipError` (an
``OSError``) for the second, as Python's ``gzip`` does; concatenated
members (BGZF) and zero padding after a member still read.

It is built with g++ (against zlib) at first use into ``build/native``
through :func:`pangaea_tpu_torch.kernels.build.load_host`; a failed build
raises with the compiler's output. Bound here: ``pgn_open``,
``pgn_close``, ``pgn_read``, ``pgn_read_lq``, ``pgn_error``,
``pgn_extract_reads`` and step 0's barcode-sort entry points
``pgn_sort_feed``, ``pgn_sort_emit`` and ``pgn_sort_radix``
(io/fastq.barcode_sort_interleaved).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

from pangaea_tpu_torch.kernels import build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "fastq_reader.cpp")


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The reader library, built on the first call."""
    lib = build.load_host(SRC, "pangaea_io")
    lib.pgn_open.restype = ctypes.c_void_p
    lib.pgn_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pgn_close.restype = None
    lib.pgn_close.argtypes = [ctypes.c_void_p]
    lib.pgn_read.restype = ctypes.c_int
    lib.pgn_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.pgn_read_lq.restype = ctypes.c_int
    lib.pgn_read_lq.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.pgn_error.restype = ctypes.c_int
    lib.pgn_error.argtypes = [ctypes.c_void_p]
    lib.pgn_extract_reads.restype = ctypes.c_longlong
    lib.pgn_extract_reads.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.pgn_sort_feed.restype = ctypes.c_longlong
    lib.pgn_sort_feed.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pgn_sort_emit.restype = ctypes.c_longlong
    lib.pgn_sort_emit.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.pgn_sort_radix.restype = ctypes.c_longlong
    lib.pgn_sort_radix.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_longlong]
    return lib


class CorruptGzipError(OSError):
    """A gzip input with a bad deflate block, header, CRC or length."""


_ERR_TRUNCATED = 1  # pgn_error(); 2 is a corrupt stream


class NativeFastqReader:
    """Bulk record reader: (codes, lengths, barcodes[, names][, lowq])
    arrays. ``codes`` is (n, max_len) uint8 (A=0, C=1, T=2, G=3, 4 =
    N/pad), ``lengths`` the full read lengths (they may exceed max_len:
    the codes are then truncated and the caller must raise). With
    ``with_lowq`` the quality mask is RETURNED as a per-base 0/1 plane
    instead of applied to the codes: the weighted masked sort-join needs
    both."""

    def __init__(self, path: str, max_len: int = 256,
                 min_qual_char: Optional[str] = None,
                 barcode_width: int = 48, name_width: int = 0,
                 with_lowq: bool = False):
        self._lib = get_lib()
        self.max_len = max_len
        self.bc_w = barcode_width
        self.nm_w = name_width
        self.with_lowq = with_lowq
        self.path = path
        mq = ord(min_qual_char) if min_qual_char else 0
        self._h = self._lib.pgn_open(path.encode(), mq)
        if not self._h:
            raise FileNotFoundError(path)

    def read(self, n: int) -> Optional[Tuple[np.ndarray, ...]]:
        """Up to ``n`` records, or None at the end of the file. Raises
        ``EOFError`` when a gzip input ends inside a member and
        :class:`CorruptGzipError` when its data is corrupt."""
        if not self._h:
            raise ValueError("read from a closed NativeFastqReader")
        codes = np.empty((n, self.max_len), np.uint8)
        lengths = np.empty(n, np.int32)
        barcodes = np.empty((n, self.bc_w), dtype="S1")
        names = (np.empty((n, self.nm_w), dtype="S1") if self.nm_w
                 else None)
        names_ptr = names.ctypes.data if names is not None else None
        if self.with_lowq:
            lowq = np.empty((n, self.max_len), np.uint8)
            got = self._lib.pgn_read_lq(
                self._h, n, self.max_len,
                codes.ctypes.data, lengths.ctypes.data,
                barcodes.ctypes.data, self.bc_w, names_ptr, self.nm_w,
                lowq.ctypes.data)
        else:
            lowq = None
            got = self._lib.pgn_read(
                self._h, n, self.max_len,
                codes.ctypes.data, lengths.ctypes.data,
                barcodes.ctypes.data, self.bc_w, names_ptr, self.nm_w)
        if got < 0:
            if self._lib.pgn_error(self._h) == _ERR_TRUNCATED:
                raise EOFError(f"{self.path}: compressed file ended before "
                               "the end-of-stream marker was reached")
            raise CorruptGzipError(f"{self.path}: corrupt gzip stream")
        if got == 0:
            return None
        out = (codes[:got], lengths[:got],
               barcodes[:got].view(f"S{self.bc_w}").ravel())
        if names is not None:
            out += (names[:got].view(f"S{self.nm_w}").ravel(),)
        if lowq is not None:
            out += (lowq[:got],)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.pgn_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
