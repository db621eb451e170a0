"""Gradient all-reduce (``train/optim.py``: the optimizer's dp average,
``parallel/mesh.py all_reduce_mean_`` over NCCL): device ms a step on rank
0, the merged device time of the records launched inside the program's
``train.grad_allreduce`` spans over the profiled steps (one a step). An
all-reduce kernel runs until the last rank's gradients arrive, so the
time holds the ranks' skew as well as the transfer."""
from portbench.harness.program import device_ms_per


def read(rec):
    return device_ms_per(rec, "train.grad_allreduce",
                         "train.grad_allreduce")
