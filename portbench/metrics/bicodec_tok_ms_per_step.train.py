"""Frozen tokenize and features, BiCodec's tokenize side
(``BiCodec.tokenize``: the feature encoder, the quantizer, the speaker
encoder): device ms a step, the merged device time of the records
launched inside the program's ``bicodec.tokenize`` spans in the
profiled steps, over those steps."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "bicodec.tokenize", "unise.frozen")
