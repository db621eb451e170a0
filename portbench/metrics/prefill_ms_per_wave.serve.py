"""Admission's prefill (``engine.admit.prefill``: the prompt, its
compaction, the cache and the LM's prefill): device ms a wave, the merged
device time of its records in the profiled wave."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "engine.admit.prefill", "engine.admit")
