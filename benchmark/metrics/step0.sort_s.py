"""Seconds per pass of step 0's ``step0.sort`` span: the
``sort_s`` of the ``step0_s`` dict that ``pipeline.driver.main``
returns, which the span fills."""

UNIT = "s"
MOVES = "memory_peak_gb"


def read(run):
    return run.per_pass(lambda p: p.step0_s.get("sort_s"))
