"""Reads binned per second: every read of every pass the window ran (each
mate counts), over the time from the window's start to the end of its
last pass. No pass is cut."""

UNIT = "reads/s"
MOVES = "reads_per_s"


def read(run):
    return run.reads / run.window_s if run.passes else None
