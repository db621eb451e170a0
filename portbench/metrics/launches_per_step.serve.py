"""Decode step: kernel launches a step, the host's launch calls inside the
profiled ``step(n)`` ranges (as ``serve/profile_step.py`` counts them)
over the steps profiled."""
from portbench.harness.readers import host_calls_in

CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
         "cuLaunchKernelEx")


def read(rec):
    n = host_calls_in(rec, "decode_step", CALLS)
    steps = rec["counts"].get("profiled_steps")
    return n / steps if n and steps else None
