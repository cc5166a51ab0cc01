"""Seconds per pass of step 1's host stream (gzip inflate, parsing and
packing, and the uploads it waits on): ``FeatureExtractor.stats``'
``stream_s`` on the sort-join path."""

UNIT = "s"
MOVES = "reads_per_s"


def read(run):
    return run.per_pass(lambda p: p.feature_stats.get("stream_s"))
