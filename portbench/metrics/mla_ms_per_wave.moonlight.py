"""Latent attention (``models/lm/moonlight.py LatentAttention``): device
ms a wave, the merged device time of the records launched inside the
program's ``lm.mla`` spans in the profiled wave over its admissions (the
prefill's: a replayed decode step records no span)."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "lm.mla", "engine.admit")
