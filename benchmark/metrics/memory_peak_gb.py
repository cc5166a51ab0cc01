"""The card's peak memory over the window, in GB (10^9 bytes): the most
the program held allocated at once (``torch.cuda.max_memory_allocated``
after a reset at the window's start), the share of the card a job
needs. Nothing off a card."""

UNIT = "GB"
MOVES = "memory_peak_gb"


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
