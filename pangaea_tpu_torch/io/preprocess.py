"""Step-0 read preprocessing: stLFR / Tell-Seq header normalization,
interleaving, barcode sort. Copied from pangaea_tpu.io.preprocess.

Contracts:

- preprocess_stlfr (src/cpptools/preprocess_stlfr.cpp:70-118): stLFR
  headers ``name#x_y_z/r`` become ``name\\tBX:Z:<barcode>`` where barcode
  is either the numeric ``x_y_z`` (-n) or the whitelist translation
  ``wl[x-1]+wl[y-1]+wl[z-1]``; with -l a ``-1`` library suffix is added.
  The *same* rewritten header is written to both mates (the R2 header is
  discarded). Fidelity quirk (:91): the reference checks
  ``bc1!="0" && bc2!="0" && bc1!="0"`` — bc3 is never checked, so
  ``x_y_0`` keeps its barcode while ``0_y_z``/``x_0_z`` lose theirs;
  replicated. A dropped barcode leaves just the read name.
- preprocess_tellseq (src/cpptools/preprocess_tellseq.cpp:52-86): the
  barcode index file is read in lockstep (a FASTQ whose 2nd line per
  record is the 18-bp barcode); headers become
  ``name\\tBX:Z:<barcode>-1``; pairs whose barcode is not exactly 18 chars
  are dropped with a warning; kept barcodes append to ``<out>.wl``.
- interleave (seqtk mergepe, src/run_pangaea:224).
- barcode sort: io/fastq.barcode_sort_interleaved (src/run_pangaea:237-252).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from pangaea_tpu_torch.io.fastq import open_maybe_gzip

log = logging.getLogger(__name__)


def load_whitelist(path: str) -> List[str]:
    """First tab-separated field per line (preprocess_stlfr.cpp:34-38)."""
    out = []
    with open_maybe_gzip(path) as f:
        for line in f:
            out.append(line.rstrip("\n").split("\t")[0])
    return out


def preprocess_stlfr(reads1: str, reads2: str, output_prefix: str,
                     numeric: bool = True, library: bool = True,
                     whitelist: Optional[List[str]] = None
                     ) -> Tuple[str, str]:
    out1, out2 = output_prefix + "_1.fq", output_prefix + "_2.fq"
    with open_maybe_gzip(reads1) as f1, open_maybe_gzip(reads2) as f2, \
            open(out1, "w") as o1, open(out2, "w") as o2:
        it1, it2 = iter(f1), iter(f2)
        for line1 in it1:
            line1 = line1.rstrip("\n")
            line2 = next(it2).rstrip("\n")
            pos1 = line1.find("#")
            pos2 = line1.find("/", pos1 + 1)
            barcode = line1[pos1 + 1: pos2 if pos2 != -1 else None]
            parts = barcode.split("_")
            bc1, bc2, bc3 = (parts + ["", "", ""])[:3]
            barcode_trans = ""
            # quirk: bc1 tested twice, bc3 never (preprocess_stlfr.cpp:91)
            if bc1 != "0" and bc2 != "0" and bc1 != "0":
                if numeric:
                    barcode_trans = barcode
                else:
                    wl = whitelist or []
                    barcode_trans = (wl[int(bc1) - 1] + wl[int(bc2) - 1]
                                     + wl[int(bc3) - 1])
            if not barcode_trans:
                identifier = line1[:pos1]
            else:
                if library:
                    barcode_trans += "-1"
                identifier = line1[:pos1] + "\tBX:Z:" + barcode_trans
            o1.write(identifier + "\n")
            o2.write(identifier + "\n")
            for _ in range(3):
                o1.write(next(it1))
                o2.write(next(it2))
    return out1, out2


def preprocess_tellseq(reads1: str, reads2: str, index: str,
                       output_prefix: str) -> Tuple[str, str]:
    out1, out2 = output_prefix + "_1.fq", output_prefix + "_2.fq"
    wl_path = output_prefix + ".wl"
    n_out = 0
    with open_maybe_gzip(reads1) as f1, open_maybe_gzip(reads2) as f2, \
            open_maybe_gzip(index) as fb, open(out1, "w") as o1, \
            open(out2, "w") as o2, open(wl_path, "w") as wl:
        it1, it2, itb = iter(f1), iter(f2), iter(fb)
        for h1 in it1:
            h1 = h1.rstrip("\n")
            next(it2)
            next(itb)
            s1, s2 = next(it1).rstrip("\n"), next(it2).rstrip("\n")
            barcode = next(itb).rstrip("\n")
            next(it1), next(it2), next(itb)
            q1, q2 = next(it1).rstrip("\n"), next(it2).rstrip("\n")
            try:
                next(itb)
            except StopIteration:
                pass
            sp = h1.find(" ")
            header = (h1[:sp if sp != -1 else len(h1)]
                      + "\tBX:Z:" + barcode + "-1")
            if len(barcode) != 18:  # preprocess_tellseq.cpp:72-76
                log.warning("Wrong barcode length.")
                continue
            wl.write(barcode + "\n")
            o1.write(f"{header}\n{s1}\n+\n{q1}\n")
            o2.write(f"{header}\n{s2}\n+\n{q2}\n")
            n_out += 1
    log.info("tellseq preprocess: %d pairs", n_out)
    return out1, out2


def interleave(reads1: str, reads2: str, out_path: str) -> None:
    """seqtk mergepe equivalent (src/run_pangaea:224)."""
    with open_maybe_gzip(reads1) as f1, open_maybe_gzip(reads2) as f2, \
            open(out_path, "w") as out:
        it1, it2 = iter(f1), iter(f2)
        for h1 in it1:
            rec1 = [h1, next(it1), next(it1), next(it1)]
            rec2 = [next(it2), next(it2), next(it2), next(it2)]
            out.writelines(rec1)
            out.writelines(rec2)
