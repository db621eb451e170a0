"""Routed experts: the share of the MoE's device time (``lm.moe``) spent
routing (``lm.moe.route``: the fp32 scores, the top-k, the sort by expert
and the gather of the rows) in the profiled wave."""
from portbench.harness.program import ranged


def read(rec):
    got = ranged(rec, "lm.moe.route")
    if got is None:
        return None
    moe = got.device_s("lm.moe")
    return got.device_s("lm.moe.route") / moe if moe else None
