"""Step 2's share of the card's float32 peak: the VAE's matmul FLOPs of
the units and rows the training actually ran (benchmark/flops.py), over
``step2.s`` times the peak in benchmark/peaks.json. The program keeps
TF32 off, so float32 outside the tensor cores is the peak that bounds
it."""

from benchmark import flops

UNIT = "%"
MOVES = "reads_per_s"


def _tnf_dim(k: int) -> int:
    return (4 ** k + (4 ** (k // 2) if k % 2 == 0 else 0)) // 2


def read(run):
    peak = run.peaks.get("fp32_flops_per_s")
    b = run.cell.config["binning"]
    total_flops = total_s = 0.0
    for p in run.passes:
        hist = p.train.get("val_history")
        secs = p.stages.get("step2_train")
        if not hist or not secs or not p.barcodes_kept:
            continue
        n = p.barcodes_kept
        epochs = max(e for e, _, _ in hist)
        total_flops += flops.step2_flops(
            int(b["v"]) + _tnf_dim(int(b["tnf_k"])), b["hidden"],
            int(b["latent"]), train_rows=n * epochs,
            val_rows=min(int(n * 0.7), 1_000_000) * len(hist),
            embed_rows=n)
        total_s += secs
    if not peak or not total_s:
        return None
    return 100.0 * total_flops / (total_s * peak)
