"""External-tool invocation layer for the assembly stage (copied from
pangaea_tpu.asm.tools).

The reference shells out to megahit, bwa, samtools, seqtk, flye,
quickmerge, jgi_summarize_bam_contig_depths, metaspades (SURVEY.md §2.4).
This module centralizes those invocations so that

- production environments with the tools installed run them exactly as
  the reference's scripts do;
- environments without them (like CI) use the built-in fallbacks
  (asm/naive.py de-Bruijn assembler, asm/mapper.py k-mer vote mapper);
- tests monkeypatch ``ToolRunner.run`` to assert the exact command lines.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


class ToolMissingError(RuntimeError):
    pass


class ToolRunner:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir

    def available(self, tool: str) -> bool:
        return shutil.which(tool) is not None

    def require(self, tool: str) -> None:
        if not self.available(tool):
            raise ToolMissingError(
                f"external tool '{tool}' not found on PATH; install it or "
                f"use the built-in fallback path")

    def run(self, command: List[str], log_name: Optional[str] = None,
            shell_cmd: Optional[str] = None, cwd: Optional[str] = None
            ) -> None:
        """Run a command; raises on failure (the reference exits the whole
        process, src/utils.py:77-80 — here the pipeline catches and
        reports)."""
        display = shell_cmd or " ".join(command)
        log.info("command started: %s", display)
        out = subprocess.DEVNULL
        if self.log_dir and log_name:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(self.log_dir, log_name), "a")
        try:
            if shell_cmd is not None:
                # pipefail: `bwa ... | samtools sort` must fail loudly
                # when the UPSTREAM stage dies, not hand samtools an
                # empty stream and exit 0 (bash for pipefail support;
                # /bin/sh may be dash)
                ret = subprocess.run(["bash", "-c",
                                      "set -o pipefail; " + shell_cmd],
                                     stdout=out, stderr=out, cwd=cwd)
            else:
                ret = subprocess.run(command, stdout=out, stderr=out,
                                     cwd=cwd)
        finally:
            if out is not subprocess.DEVNULL:
                out.close()
        if ret.returncode:
            raise RuntimeError(f"command failed ({ret.returncode}): "
                               f"{display}")
        log.info("command completed: %s", display)
