"""Device: the share of the profiled batches (three round trips, the codes
and waveforms brought to the host) in which no kernel or copy ran on the
card."""
from portbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
