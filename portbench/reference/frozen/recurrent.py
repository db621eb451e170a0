# Frozen copy of unified_audio_tpu_torch/nn/recurrent.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""LSTM on channels-last (B, T, C) tensors.

Port of ``LSTM`` in ``unified_audio_tpu/nn/recurrent.py``. The JAX package
scans the recurrence by hand; here ``torch.nn.LSTM`` runs it (cuDNN on the
card), with the same parameters: gate order i, f, g, o, separate ``b_ih`` and
``b_hh``, zero initial state, batch first. Parameter names are
``torch.nn.LSTM``'s (``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``,
``bias_hh_l0``), the reference layout. cuDNN computes fp32 LSTMs in TF32
unless ``torch.backends.cudnn.allow_tf32`` is False: the callers that run
fp32 (``cli.py``) turn it off before the first forward. ``SLSTM`` (the
SEANet decoder's) adds the input back: y = x + LSTM(x), or LSTM(x) without
``skip``; its LSTM sits at ``lstm``.
"""
from __future__ import annotations

from torch import nn


class LSTM(nn.LSTM):
    """Unidirectional multi-layer LSTM, batch first: (B, T, C) -> (B, T, H)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True)

    def forward(self, x):
        return super().forward(x)[0]


class SLSTM(nn.Module):
    """Skip-LSTM over (B, T, dimension): x + LSTM(x) (``skip``) or
    LSTM(x), ``num_layers`` layers at ``lstm``."""

    def __init__(self, dimension: int, num_layers: int = 2,
                 skip: bool = True):
        super().__init__()
        self.skip = skip
        self.lstm = LSTM(dimension, dimension, num_layers)

    def forward(self, x):
        y = self.lstm(x)
        return x + y if self.skip else y
