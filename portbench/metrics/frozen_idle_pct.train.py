"""Frozen tokenize and features (``UniSE.frozen_inputs``): the share of
the host's ``unise.frozen`` intervals in the profiled steps in which no
device record ran."""
from portbench.harness.program import idle_pct_in


def read(rec):
    return idle_pct_in(rec, "unise.frozen")
