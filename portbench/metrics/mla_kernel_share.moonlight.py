"""Latent attention (``models/lm/moonlight.py LatentAttention``): the share
of the profiled wave's latent-attention calls (the prefill's and those of
the replayed decode steps) made through the kernel K8, the program's
``lm.mla.kernel`` counter over its ``lm.mla.calls``; None where the
program counts no latent-attention call."""
from portbench.harness.program import counter


def read(rec):
    calls = counter(rec, "lm.mla.calls")
    return (counter(rec, "lm.mla.kernel") or 0) / calls if calls else None
