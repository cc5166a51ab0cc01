"""The CUDA scan's share of its memory roofline: 8 bytes per element (one
int32 read, one written) of every ``cummax``, ``cummin_reverse`` and
``cumsum`` the window launched, over the HBM bandwidth in
benchmark/peaks.json, over the summed time of the ``scan_kernel``
events in the trace."""

from benchmark import flops

UNIT = "%"
MOVES = "reads_per_s"


def read(run):
    t, bw = run.trace, run.peaks.get("hbm_bytes_per_s")
    if t is None or not bw or not t.scan_lengths:
        return None
    secs = sum(v for k, v in t.kernel_s.items() if "scan_kernel" in k)
    if not secs:
        return None
    return 100.0 * flops.scan_bytes(t.scan_lengths) / bw / secs
