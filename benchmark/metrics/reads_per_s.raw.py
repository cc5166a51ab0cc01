"""``reads_per_s`` (every read of every pass the window ran, over the time
from the window's start to the end of its last pass) in the cells that
run step 0 from raw reads, where it is too unsteady from run to run to
hold to a bound and stands as a per-layer reading of the whole pass."""

from benchmark import harness

UNIT = "reads/s"
MOVES = "memory_peak_gb"
read = harness.sibling(__file__, "reads_per_s")
