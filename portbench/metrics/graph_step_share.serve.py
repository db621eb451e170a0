"""Decode step (``serve/engine.py step``): the share of the profiled steps
run as replays of a captured CUDA graph, the program's
``engine.graph_steps`` counter over the sum of its ``engine.step`` spans'
``n`` in the profiled wave."""
from portbench.harness.program import counter, spans


def read(rec):
    replayed, steps = counter(rec, "engine.graph_steps"), spans(
        rec, "engine.step")
    total = sum(s["attrs"]["n"] for s in steps) if steps else 0
    return replayed / total if replayed and total else None
