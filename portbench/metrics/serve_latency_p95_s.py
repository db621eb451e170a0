"""Clients: the 95th percentile of the utterance latency, from the client's
send to its waveform on the host, over every utterance completed in the
window."""
from portbench.harness.readers import p95


def read(rec):
    return p95(rec.get("latencies"))
