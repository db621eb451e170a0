"""Mixed precision: cast a module's floating state to one dtype.

Port of ``cast_floating`` in ``unified_audio_tpu/utils/precision.py``. The
JAX package casts every floating leaf of a variable tree, the codebook
collection included; here that is every floating parameter and buffer of a
module (a residual VQ's ``embed``, ``embed_avg`` and ``cluster_size``
among them). Integer and boolean tensors keep their dtype. The modules
keep their numerically sensitive parts in fp32 themselves (softmax and norm
statistics, the VQ search, the ISTFT head).
"""
from __future__ import annotations

import torch
from torch import nn


def cast_floating(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast the floating parameters and buffers of ``module`` to ``dtype``
    in place; ints and bools untouched. Returns ``module``."""
    return module._apply(
        lambda t: t.to(dtype) if t.is_floating_point() else t)
