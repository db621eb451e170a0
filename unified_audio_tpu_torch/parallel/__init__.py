"""Parallel training on ``torch.distributed``: process start-up and hybrid
meshes (``distributed``), named ``DeviceMesh``es, the LM's tensor-parallel
sharding and the collectives autograd runs through (``mesh``), the GPipe
schedule over the layer stack (``pipeline``) and the all-gather-KV
sequence-parallel prefill (``sequence``).

Port of ``unified_audio_tpu/parallel``. The JAX package annotates
shardings and lets GSPMD insert the collectives; here each rank runs its
own slice and the collectives are explicit: Megatron's column- and
row-parallel pairs over "tp", a ring permute over "pp", an all-gather of
keys and values over "sp", and one gradient all-reduce over "dp" a step.
"""
from . import distributed, mesh, pipeline, sequence  # noqa: F401
