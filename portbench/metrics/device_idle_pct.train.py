"""Device: the share of the profiled steps (three, their batches' waits
included) in which no kernel or copy ran on the card."""
from portbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
