"""Seconds per pass of ``Pipeline.step3_cluster`` (the program's StageTimer,
host clock around the whole step, whose outputs are on the host when it
ends)."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(lambda p: p.stages.get("step3_cluster"))
