"""Training data (``TrainDataIterator``'s worker threads): the CPU ms the
workers spent making samples (the program's ``data.loader_cpu_s``, each
sample's ``time.thread_time``) over the profiled steps (the program's
``unise.frozen`` spans, one a step)."""
from portbench.harness.program import counter, spans


def read(rec):
    cpu_s, steps = counter(rec, "data.loader_cpu_s"), spans(
        rec, "unise.frozen")
    return 1e3 * cpu_s / len(steps) if cpu_s and steps else None
