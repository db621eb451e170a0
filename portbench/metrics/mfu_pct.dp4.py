"""Device: the window's model operations on every rank (each step's
frozen inputs and the LM's forward and backward, fp32, counted on the
reference's modules for each rank's tasks and summed over the ranks) over
the ranks' fp32 peaks, over the window's time."""
from portbench.harness.peaks import PEAK_OPS_S


def read(rec):
    c = rec["counts"]
    if not c.get("fp32_flops") or not c.get("ranks") \
            or not rec.get("window_s"):
        return None
    return 100.0 * c["fp32_flops"] / (c["ranks"] * PEAK_OPS_S["fp32"]) \
        / rec["window_s"]
