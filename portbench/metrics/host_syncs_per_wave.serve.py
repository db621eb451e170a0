"""Admission and the wave around it: the host's synchronizing CUDA calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, synchronous ``cudaMemcpy``) inside a program
span in the profiled wave, a wave. The benchmark's own closing
synchronizes lie outside every program span and are not counted."""
from portbench.harness.program import ranged


def read(rec):
    got = ranged(rec, "engine.admit")
    if got is None:
        return None
    return len(got.syncs()) / len(got.program_ranges("engine.admit"))
