"""Transformer primitives: RoPE and RMSNorm.

Port of ``unified_audio_tpu/nn/transformer.py`` (``rope_cos_sin``,
``rotate_half``, ``apply_rope``, ``RMSNorm``). Layouts follow the JAX
package: q/k are (B, T, H, D).
"""
from __future__ import annotations

import torch
from torch import nn


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """cos/sin tables for GPT-NeoX style RoPE, fp32.

    positions: (..., T) int -> cos, sin each (..., T, dim)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: (B, T, H, D); cos/sin: (T, D) or (B, T, D), fp32.

    The rotation runs in fp32 and the results are cast back to q/k's dtype,
    so a bf16 model stays bf16 downstream of the attention."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q_out = (q * cos + rotate_half(q) * sin).to(q.dtype)
    k_out = (k * cos + rotate_half(k) * sin).to(k.dtype)
    return q_out, k_out


def rms_norm(x, weight, eps: float = 1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, statistics in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)
