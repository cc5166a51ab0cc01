"""The share of the traced window in which no operation (kernel, copy or
memset) ran on the card, from the benchmark's own torch.profiler trace."""

UNIT = "%"
MOVES = "reads_per_s"


def read(run):
    t = run.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
