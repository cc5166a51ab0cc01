"""Seconds from the start of the process to the start of the window:
imports, loading (or, in a fresh checkout, building) the kernels, making
the inputs and the warm-up pass."""

UNIT = "s"
MOVES = "setup_s"


def read(run):
    return run.setup_s
