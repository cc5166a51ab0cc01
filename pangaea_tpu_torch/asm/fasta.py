"""FASTA utilities: parse_header rename, seqtk-equivalent filters
(copied from pangaea_tpu.asm.fasta).

Contracts:
- rename_contigs = parse_header.cpp:1-17 — every '>' line becomes
  ``>contig_<n>`` with a global 1-based counter; body lines pass through.
- filter_min_len = ``seqtk seq -L <n>`` (drop sequences shorter than n).
- subseq = ``seqtk subseq <fa> <list>`` (keep sequences named in list,
  in the order they appear in the fasta).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from pangaea_tpu_torch.io.fastq import open_maybe_gzip


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yields (header_without_gt, sequence)."""
    name, parts = None, []
    with open_maybe_gzip(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line[1:], []
            else:
                parts.append(line)
    if name is not None:
        yield name, "".join(parts)


def write_fasta(path: str, records: Iterable[Tuple[str, str]],
                width: int = 0) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            if width:
                for i in range(0, len(seq), width):
                    f.write(seq[i:i + width] + "\n")
            else:
                f.write(seq + "\n")


def fasta_sizes(path: str) -> Dict[str, int]:
    return {name.split()[0]: len(seq) for name, seq in iter_fasta(path)}


def rename_contigs(in_path: str, out_path: str,
                   start: int = 1) -> int:
    """parse_header.cpp: line-level rewrite (preserves body line wrap)."""
    cnt = start - 1
    with open_maybe_gzip(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith(">"):
                cnt += 1
                fout.write(f">contig_{cnt}\n")
            else:
                fout.write(line if line.endswith("\n") else line + "\n")
    return cnt


def concat_fastas(inputs: List[str], out_path: str) -> None:
    """cat a b c > out, newline-safe (merge_olc.py concat_files)."""
    with open(out_path, "w") as fout:
        for path in inputs:
            last = "\n"
            with open_maybe_gzip(path) as fin:
                for line in fin:
                    fout.write(line)
                    last = line
            if not last.endswith("\n"):
                fout.write("\n")


def filter_min_len(in_path: str, out_path: str, min_len: int,
                   append: bool = False) -> int:
    n = 0
    with open(out_path, "a" if append else "w") as f:
        for name, seq in iter_fasta(in_path):
            if len(seq) >= min_len:
                f.write(f">{name}\n{seq}\n")
                n += 1
    return n


def subseq(fa_path: str, names: Iterable[str], out_path: str) -> int:
    keep = set(names)
    n = 0
    with open(out_path, "w") as f:
        for name, seq in iter_fasta(fa_path):
            if name.split()[0] in keep:
                f.write(f">{name}\n{seq}\n")
                n += 1
    return n


def read_name_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]
