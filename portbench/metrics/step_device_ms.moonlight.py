"""Decode step (``serve/engine.py step`` over the Moonlight stack and its
latent pool): device ms a step, the merged device time of the records
launched inside the program's ``engine.step`` spans in the profiled wave
over the steps profiled."""
from portbench.harness.program import ranged


def read(rec):
    got, steps = ranged(rec, "engine.step"), rec["counts"].get(
        "profiled_steps")
    if got is None or not steps:
        return None
    return 1e3 * got.device_s("engine.step") / steps
