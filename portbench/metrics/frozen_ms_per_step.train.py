"""Frozen tokenize and features (`UniSE.frozen_inputs`: XLSR-53, BiCodec's
tokenize side, WavLM): mean ms a step, from the benchmark's spans around
each piece of ``train_step`` in a traced run (closed by a synchronize)."""
from portbench.harness.readers import ms_per_span


def read(rec):
    return ms_per_span(rec, "frozen")
