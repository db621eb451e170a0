"""Device: the round trips' model operations (HuBERT, the codec's encoder,
VQ and decoder, all fp32, counted on the reference's modules at the
cell's batch, LSTMs included) at the fp32 peak, over the window's time."""
from portbench.harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, {"fp32_flops": "fp32"})
