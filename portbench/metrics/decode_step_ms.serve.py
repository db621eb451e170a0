"""Decode step (``serve/engine.py step``, ``serve/paged.py``, the LM): ms a
step, the spans around each ``step(n)`` call over the steps they ran."""
from portbench.harness.readers import ms_per_unit


def read(rec):
    return ms_per_unit(rec, "decode_step", "steps")
