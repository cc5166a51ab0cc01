"""Seconds per pass of step 3's ``step3.rph`` span: the final
RPH-k-means (``Pipeline.cluster_stats["rph_s"]``, which the span
fills)."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(lambda p: p.cluster.get("rph_s"))
