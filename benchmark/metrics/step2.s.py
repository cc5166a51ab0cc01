"""Seconds per pass of ``Pipeline.step2_train`` (the program's StageTimer,
host clock around the whole step, whose outputs are on the host when it
ends)."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(lambda p: p.stages.get("step2_train"))
