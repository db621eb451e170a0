"""RVQ search K6 (``vq_search_kernel``, ``csrc/vq.cu``): the least time of
its calls in the profiled batches (x and the codebooks read once, the
codes written once, or 2 M N D operations a layer as three TF32
products, counted from the shapes) over the device time of its records.
A kernel that replaces it is read once its name is added to ``KERNELS``."""
from portbench.harness.readers import roofline_pct

KERNELS = ("vq_search_kernel",)


def read(rec):
    return roofline_pct(rec, "k6_least_s", "k6_calls", KERNELS)
