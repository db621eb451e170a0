"""unified_audio_tpu_torch: the PyTorch/CUDA port of unified_audio_tpu.

Module paths mirror the JAX package (``unified_audio_tpu``), which stays the
reference every piece here is held against. This package imports ``torch``
and never ``jax``; its hand-written kernels target NVIDIA Hopper (sm_90a).
"""

__version__ = "0.1.0"
