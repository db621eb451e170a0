"""Attention kernel K1 (``owner_decode_kernel_tiled``,
``csrc/paged_attention.cu``): the least time of its calls in the
profiled wave (each live K/V row, q and the output moved once at 3.35
TB/s, or the dot products at the bf16 peak, counted from the slots'
depths) over the device time of its records. A kernel that replaces it
is read once its name is added to ``KERNELS``."""
from portbench.harness.readers import roofline_pct

KERNELS = ("owner_decode_kernel_tiled",)


def read(rec):
    return roofline_pct(rec, "k1_least_s", "k1_calls", KERNELS)
