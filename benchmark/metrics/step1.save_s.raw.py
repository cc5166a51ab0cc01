"""``step1.save_s`` in the cells that run step 0 from raw reads,
where it moves ``memory_peak_gb``."""

from benchmark import harness

UNIT = "s"
MOVES = "memory_peak_gb"
read = harness.sibling(__file__, "step1.save_s")
