# Frozen copy of unified_audio_tpu_torch/nn/heads.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""Fourier reconstruction head of the HCodec decoders.

Port of ``ISTFTHead`` in ``unified_audio_tpu/nn/heads.py``: a linear layer
to (log-magnitude, phase), then exp (clipped at 1e2), cos/sin and the
"same"-padded ISTFT, all in fp32 (in fp64 for an fp64 model). The weight
sits at ``out``.
"""
from __future__ import annotations

import torch
from torch import nn

from .dsp import istft_same


class ISTFTHead(nn.Module):
    """(B, T, dim) -> waveform (B, T * hop_length)."""

    def __init__(self, dim: int, n_fft: int, hop_length: int):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.out = nn.Linear(dim, n_fft + 2)

    def forward(self, x):
        n = self.n_fft // 2 + 1
        out = self.out(x)
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        mag = torch.exp(out[..., :n]).clamp(max=1e2)
        phase = out[..., n:]
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        return istft_same(spec.transpose(1, 2), self.n_fft, self.hop_length)
