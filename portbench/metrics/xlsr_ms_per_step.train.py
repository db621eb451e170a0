"""Frozen tokenize and features, XLSR-53's features
(``BiCodecTokenizer.extract_features``): device ms a step, the merged
device time of the records launched inside the program's
``bicodec.xlsr`` spans in the profiled steps, over those steps."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "bicodec.xlsr", "unise.frozen")
