"""Encoder + RVQ (`models/hcodec/codec.py HCodec.encode`: SEANet and
semantic encoders, the residual VQs through K6): mean ms a batch of 16 x
10 s, from the benchmark's spans around each call in a traced run
(closed by a synchronize)."""
from portbench.harness.readers import ms_per_span


def read(rec):
    return ms_per_span(rec, "encode")
