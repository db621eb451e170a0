"""Decode step: 100 x its byte bound over its device time, over the
profiled steps. The bound (``harness/moe_counts.py step_bytes`` over 3.35
TB/s, or the operations over the bf16 peak where larger) reads each weight
the step needs once (the routed experts its tokens reach, at the
expectation, the dense and attention weights, the head) and each live
latent row once; the device time is ``step_device_ms.moonlight``'s."""
from portbench.harness.program import ranged


def read(rec):
    got, least = ranged(rec, "engine.step"), rec["counts"].get(
        "step_least_s")
    if got is None or not least:
        return None
    busy = got.device_s("engine.step")
    return 100.0 * least / busy if busy else None
