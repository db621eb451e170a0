"""Admission (``serve/engine.py admit_many``: the WavLM frontend, prompt
assembly, prefill, scatter into the pool): mean ms a wave, from the
benchmark's spans around each call (closed by a synchronize)."""
from portbench.harness.readers import ms_per_span


def read(rec):
    return ms_per_span(rec, "admit")
