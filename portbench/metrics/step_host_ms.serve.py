"""Decode step (``serve/engine.py step``): the host's ms a step, the
program's ``engine.step`` spans over the sum of their ``n``, across the
profiled wave (no synchronize: what the host spent dispatching)."""
from portbench.harness.program import host_ms_per_unit


def read(rec):
    return host_ms_per_unit(rec, "engine.step", "n")
