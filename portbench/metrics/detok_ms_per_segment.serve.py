"""Detokenize (BiCodec's decoder, ``UniSE._decode_tokens``): ms a 5-s
segment, the spans around each utterance's decoding over its segments."""
from portbench.harness.readers import ms_per_unit


def read(rec):
    return ms_per_unit(rec, "detokenize", "segments")
