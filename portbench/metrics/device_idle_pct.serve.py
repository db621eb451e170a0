"""Device: the share of the profiled wave (admission, its decode steps,
harvest, detokenize) in which no kernel or copy ran on the card."""
from portbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
