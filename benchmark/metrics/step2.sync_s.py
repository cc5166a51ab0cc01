"""Seconds per pass of step 2's ``step2.sync`` spans: the host waiting
for each chunk's rows, the one device-to-host read per chunk (the fused
loop's ``phase_times["sync"]``, which the spans fill)."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(
        lambda p: p.train.get("phase_times", {}).get("sync"))
