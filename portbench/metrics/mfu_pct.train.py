"""Device: the window's model operations (each step's frozen inputs and the
LM's forward and backward, fp32, counted on the reference's modules for
its task) at the fp32 peak, over the window's time."""
from portbench.harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, {"fp32_flops": "fp32"})
