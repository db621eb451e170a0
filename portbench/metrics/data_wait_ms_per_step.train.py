"""Training data (`data/data_module.py TrainDataIterator`, `Prefetcher`):
the wait for the next batch: mean ms a step, from the benchmark's spans
around each piece of ``train_step`` in a traced run (closed by a
synchronize)."""
from portbench.harness.readers import ms_per_span


def read(rec):
    return ms_per_span(rec, "data_wait")
