"""Frozen tokenize and features, WavLM over the mix and the enrollment:
device ms a step, the merged device time of the records launched inside
the program's ``unise.frozen.wavlm`` spans in the profiled steps, over
those steps."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "unise.frozen.wavlm", "unise.frozen")
