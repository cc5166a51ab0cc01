"""Seconds per pass of step 2's ``step2.dispatch`` spans: the host's time
launching the fused loop's units, chunk by chunk (the fused loop's
``phase_times["dispatch"]``, which the spans fill)."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(
        lambda p: p.train.get("phase_times", {}).get("dispatch"))
