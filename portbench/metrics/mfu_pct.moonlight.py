"""Device: model operations of the window (the Moonlight LM's prefill and
decode, its routed experts as used, at the bf16 peak; WavLM and BiCodec's
decoder, fp32, at the fp32 peak) over the window's time."""
from portbench.harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, {"lm_flops_bf16": "bf16", "fp32_flops": "fp32"})
