"""Seconds per pass of step 3's ``step3.extract`` span: the per-bin read
extraction (the clusters TSV read back, the input read again, the
per-bin FASTQs written; ``Pipeline.cluster_stats["extract_s"]``, which
the span fills)."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(lambda p: p.cluster.get("extract_s"))
