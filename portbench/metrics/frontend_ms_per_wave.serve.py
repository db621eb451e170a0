"""Admission's frontend (``engine.admit.frontend``: the staged rows
gathered, the int16 wire decoded, WavLM on each waveform): device ms a
wave, the merged device time of its records in the profiled wave."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "engine.admit.frontend", "engine.admit")
