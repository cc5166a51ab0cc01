"""Minimal BAM (BGZF) reader/writer — htslib replacement for the asm layer.

Copied from pangaea_tpu.io.bam (the mapper's BAM bytes must equal
pangaea_tpu's).

The reference links htslib for three tools (extract_unmapped.cpp,
add_barcode.cpp, assign_barcodes.cpp — src/cpptools/CMakeLists.txt:82-97).
pysam is not vendored here, so this module implements the subset of the
BAM spec those tools touch:

- BGZF framing (gzip members with the BC extra field), read + write.
- header: reference names and lengths.
- records: qname, flag, tid, pos, mapq, CIGAR, seq, qual, and integer aux
  tags (NM); alignment end position from the CIGAR.

SAM spec reference: https://samtools.github.io/hts-specs/SAMv1.pdf.
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, List, Optional, Tuple

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
# byte -> nt16 nibble LUT (lowercase included); unknown bases -> N (15)
_NT16_LUT = np.full(256, 15, np.uint8)
for _i, _c in enumerate(_SEQ_NT16):
    _NT16_LUT[ord(_c)] = _i
    _NT16_LUT[ord(_c.lower())] = _i
_NT16_BYTES = np.frombuffer(_SEQ_NT16.encode("ascii"), np.uint8)

# flags (SAM spec §1.4)
FPAIRED = 0x1
FUNMAP = 0x4
FREVERSE = 0x10
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    qname: str
    flag: int
    tid: int
    pos: int          # 0-based leftmost
    mapq: int
    cigar: List[Tuple[str, int]]  # [(op, len), ...]
    seq: str
    qual: str         # ASCII phred+33 ("" if absent)
    tags: dict = field(default_factory=dict)
    next_tid: int = -1
    next_pos: int = -1
    tlen: int = 0

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & FREAD1)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & FREAD2)

    def alignment_columns(self) -> int:
        """M + I + D cigar columns (extract_unmapped.cpp:102-109)."""
        return sum(n for op, n in self.cigar if op in "MID")

    def end_pos(self) -> int:
        """0-based end = pos + reference-consumed length (bam_endpos
        semantics: pos+1 when no reference bases are consumed)."""
        ref = sum(n for op, n in self.cigar if op in "MDN=X")
        return self.pos + (ref if ref else 1)


_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


# ---- BGZF framing ----------------------------------------------------------

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_compress_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6
              + b"\x06\x00" + b"BC" + b"\x02\x00"
              + struct.pack("<H", bsize - 1))
    return (header + comp + struct.pack("<I", zlib.crc32(data))
            + struct.pack("<I", len(data)))


def bgzf_write(handle: BinaryIO, data: bytes,
               block_size: int = 60000) -> None:
    for i in range(0, len(data), block_size):
        handle.write(_bgzf_compress_block(data[i:i + block_size]))


def bgzf_read_all(path: str) -> bytes:
    """gzip supports concatenated members, which covers BGZF."""
    with gzip.open(path, "rb") as f:
        return f.read()


# ---- BAM record codec ------------------------------------------------------

def _decode_record(buf: memoryview, off: int) -> Tuple[BamRecord, int]:
    (block_size,) = struct.unpack_from("<i", buf, off)
    start = off + 4
    (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, next_tid,
     next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", buf, start)
    p = start + 32
    qname = bytes(buf[p:p + l_read_name - 1]).decode()
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", buf, p)
        cigar.append((_CIGAR_OPS[v & 0xF], v >> 4))
        p += 4
    seq_bytes = buf[p:p + (l_seq + 1) // 2]
    p += (l_seq + 1) // 2
    # vectorized nibble expansion (the per-char join dominated the
    # builtin extract_unmapped pass over soak-scale BAMs)
    packed = np.frombuffer(seq_bytes, np.uint8)
    nib = np.empty(packed.shape[0] * 2, np.uint8)
    nib[0::2] = packed >> 4
    nib[1::2] = packed & 0xF
    seq = _NT16_BYTES[nib[:l_seq]].tobytes().decode("ascii")
    qual_raw = bytes(buf[p:p + l_seq])
    p += l_seq
    qual = ("" if (not qual_raw or qual_raw[0] == 0xFF)
            else (np.frombuffer(qual_raw, np.uint8)
                  + np.uint8(33)).tobytes().decode("ascii"))
    end = start + block_size
    tags = {}
    while p < end:
        tag = bytes(buf[p:p + 2]).decode()
        typ = chr(buf[p + 2])
        p += 3
        if typ in "cC":
            (v,) = struct.unpack_from("<b" if typ == "c" else "<B", buf, p)
            p += 1
        elif typ in "sS":
            (v,) = struct.unpack_from("<h" if typ == "s" else "<H", buf, p)
            p += 2
        elif typ in "iI":
            (v,) = struct.unpack_from("<i" if typ == "i" else "<I", buf, p)
            p += 4
        elif typ == "f":
            (v,) = struct.unpack_from("<f", buf, p)
            p += 4
        elif typ in "ZH":
            q = p
            while buf[q] != 0:
                q += 1
            v = bytes(buf[p:q]).decode()
            p = q + 1
        elif typ == "A":
            v = chr(buf[p])
            p += 1
        elif typ == "B":
            sub = chr(buf[p])
            (cnt,) = struct.unpack_from("<I", buf, p + 1)
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
                    "f": 4}[sub]
            v = bytes(buf[p + 5:p + 5 + cnt * size])
            p += 5 + cnt * size
        else:
            raise ValueError(f"unknown tag type {typ!r}")
        tags[tag] = v
    rec = BamRecord(qname, flag, tid, pos, mapq, cigar, seq, qual, tags,
                    next_tid, next_pos, tlen)
    return rec, end


class BamReader:
    def __init__(self, path: str):
        data = bgzf_read_all(path)
        assert data[:4] == b"BAM\x01", "not a BAM file"
        (l_text,) = struct.unpack_from("<i", data, 4)
        p = 8 + l_text
        self.text = data[8:8 + l_text].decode(errors="replace")
        (n_ref,) = struct.unpack_from("<i", data, p)
        p += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", data, p)
            p += 4
            self.references.append(data[p:p + l_name - 1].decode())
            p += l_name
            (l_ref,) = struct.unpack_from("<i", data, p)
            p += 4
            self.lengths.append(l_ref)
        self._data = memoryview(data)
        self._start = p

    def __iter__(self) -> Iterator[BamRecord]:
        p = self._start
        data = self._data
        n = len(data)
        while p < n:
            rec, p = _decode_record(data, p)
            yield rec

    def ref_name(self, tid: int) -> Optional[str]:
        if 0 <= tid < len(self.references):
            return self.references[tid]
        return None


class BamWriter:
    """Enough of a writer to build test fixtures and hybrid-mode inputs."""

    def __init__(self, path: str, references: List[str], lengths: List[int],
                 text: str = ""):
        self.handle = open(path, "wb")
        self.references = references
        header = b"BAM\x01"
        t = text.encode()
        header += struct.pack("<i", len(t)) + t
        header += struct.pack("<i", len(references))
        for name, ln in zip(references, lengths):
            nb = name.encode() + b"\x00"
            header += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._buf = bytearray(header)

    # streaming flush threshold: the builtin mapper writes millions of
    # records; holding the whole uncompressed stream until close() both
    # ballooned RSS and serialized all BGZF work at the end
    _FLUSH_BYTES = 8 << 20

    def write(self, rec: BamRecord,
              seq_bytes: Optional[bytes] = None,
              qual_bytes: Optional[bytes] = None) -> None:
        """``seq_bytes``/``qual_bytes``: pre-encoded nt16-packed seq and
        raw phred payloads (bulk callers like the mapper's flush encode
        a whole batch in one numpy pass and hand slices in)."""
        qname = rec.qname.encode() + b"\x00"
        body = struct.pack(
            "<iiBBHHHiiii", rec.tid, rec.pos, len(qname), rec.mapq, 0,
            len(rec.cigar), rec.flag, len(rec.seq), rec.next_tid,
            rec.next_pos, rec.tlen)
        body += qname
        for op, ln in rec.cigar:
            body += struct.pack("<I", (ln << 4) | _CIGAR_OPS.index(op))
        # vectorized nt16 nibble packing + qual offset: the per-char
        # Python loops were the top cost of the 2.5M-read soak's mapback
        # (30M str.index calls; tottime ~12 s per 100k pairs)
        if seq_bytes is not None:
            body += seq_bytes
        else:
            nib = _NT16_LUT[np.frombuffer(rec.seq.encode("ascii"),
                                          np.uint8)]
            if nib.shape[0] % 2:
                nib = np.concatenate([nib, np.zeros(1, np.uint8)])
            body += ((nib[0::2] << 4) | nib[1::2]).tobytes()
        if qual_bytes is not None:
            body += qual_bytes
        elif rec.qual:
            body += (np.frombuffer(rec.qual.encode("ascii"), np.uint8)
                     - np.uint8(33)).tobytes()
        else:
            body += b"\xff" * len(rec.seq)
        for tag, v in rec.tags.items():
            if isinstance(v, int):
                body += tag.encode() + b"i" + struct.pack("<i", v)
            elif isinstance(v, float):
                body += tag.encode() + b"f" + struct.pack("<f", v)
            else:
                body += tag.encode() + b"Z" + str(v).encode() + b"\x00"
        self._buf += struct.pack("<i", len(body)) + body
        if len(self._buf) >= self._FLUSH_BYTES:
            # BGZF blocks are independent; flushing mid-stream yields the
            # identical decompressed byte stream
            bgzf_write(self.handle, bytes(self._buf))
            self._buf = bytearray()

    def close(self) -> None:
        bgzf_write(self.handle, bytes(self._buf))
        self.handle.write(_BGZF_EOF)
        self.handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
