"""Seconds per pass of step 1's ``step1.save`` span: the write of the
feature CSVs and the marker, on a thread of its own behind step 2
(``FeatureExtractor.stats["save_s"]``, which the span fills)."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(lambda p: p.feature_stats.get("save_s"))
