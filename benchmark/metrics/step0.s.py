"""Seconds per pass of step 0: the sum of the sub-stage seconds
(``preprocess_s``, ``interleave_s``, ``sort_s``) that
``pipeline.driver.main`` returns as ``step0_s``."""

UNIT = "s"
MOVES = "memory_peak_gb"


def read(run):
    return run.per_pass(
        lambda p: sum(p.step0_s.values()) if p.step0_s else None)
