"""Share of step 2's units that the fused loop ran as CUDA graph replays,
per pass: 100 x ``phase_times["graph_units"]`` over
``phase_times["units"]``, the mean over the passes. A program without the
counter reads nothing."""

UNIT = "%"
MOVES = "reads_per_s"


def _share(p):
    pt = p.train.get("phase_times", {})
    graphed, units = pt.get("graph_units"), pt.get("units")
    if graphed is None or not units:
        return None
    return 100.0 * graphed / units


def read(run):
    return run.per_pass(_share)
