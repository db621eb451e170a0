"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates,
without sparsity, at the 700 W limit) and the least time a piece of work
can take on it.

Copied from ``chip_smoke.py`` (``HBM_BYTES_S``, ``PEAK_OPS_S``, ``bound``)
so that a later change to the smoke cannot move the yardstick.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}


def bound_s(bytes_moved: float, ops: float, ops_type: str):
    """-> (seconds, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the peak of ``ops_type``."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[ops_type]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
