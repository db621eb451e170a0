"""Routed experts (``nn/transformer.py MoE``: the router, the grouped
GEMMs, the shared experts): device ms a wave, the merged device time of
the records launched inside the program's ``lm.moe`` spans in the profiled
wave over its admissions. The decode steps replay a CUDA graph, which
records no span: this is the prefill's MoE."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "lm.moe", "engine.admit")
