"""Transformer primitives: RoPE, RMSNorm, the gated MLP, attention and the
HCodec hybrid LSTM-attention transformer.

Port of ``unified_audio_tpu/nn/transformer.py`` (``rope_cos_sin``,
``rotate_half``, ``apply_rope``, ``RMSNorm``, ``GatedMLP``, ``causal_mask``,
``attend``, ``HybridAttention``, ``TransformerLayer``, ``Transformer``).
Layouts follow the JAX package: q/k are (B, T, H, D). Parameter names follow
the reference layout (``self_attn.rnn.weight_ih_l0``, ``self_attn.q_proj``,
``mlp.w1``, ``input_layernorm.weight``). The routed-expert ``MoE`` is not
ported: HCodec-1.0 runs without it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .recurrent import LSTM

NEG_INF = -1e9  # additive mask value: a fully masked row stays finite


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


class GatedMLP(nn.Module):
    """w2(silu(w1 x) * w3 x), no biases."""

    def __init__(self, dim: int, inter_dim: int):
        super().__init__()
        self.w1 = nn.Linear(dim, inter_dim, bias=False)
        self.w2 = nn.Linear(inter_dim, dim, bias=False)
        self.w3 = nn.Linear(dim, inter_dim, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def causal_mask(t: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(T, T) additive mask: 0 where visible, NEG_INF above the diagonal."""
    row = torch.arange(t, device=device)[:, None]
    col = torch.arange(t, device=device)[None, :]
    return torch.where(col <= row, 0.0, NEG_INF).to(dtype)


def attend(q, k, v, mask: Optional[torch.Tensor], scale: float):
    """Softmax attention with fp32 logits and softmax. q, k, v (B, T, H, D);
    ``mask`` additive (T, S), (B, T, S) or (B, H, T, S), or None."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None]
        elif mask.dim() == 3:
            mask = mask[:, None]
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class HybridAttention(nn.Module):
    """An LSTM, then q/k/v projections with bias, RoPE, attention and
    ``o_proj`` without bias."""

    def __init__(self, hidden: int, num_heads: int, head_dim: int):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.rnn = LSTM(hidden, hidden)
        self.q_proj = nn.Linear(hidden, inner)
        self.k_proj = nn.Linear(hidden, inner)
        self.v_proj = nn.Linear(hidden, inner)
        self.o_proj = nn.Linear(inner, hidden, bias=False)

    def forward(self, x, mask, cos, sin):
        x = self.rnn(x)
        shape = (*x.shape[:-1], self.num_heads, self.head_dim)
        q, k = apply_rope(self.q_proj(x).view(shape),
                          self.k_proj(x).view(shape), cos, sin)
        out = attend(q, k, self.v_proj(x).view(shape), mask,
                     self.head_dim ** -0.5)
        return self.o_proj(out.reshape(*x.shape[:-1], -1))


class TransformerLayer(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_heads: int, head_dim: int, use_moe: bool = False):
        super().__init__()
        if use_moe:
            raise NotImplementedError(
                "the routed-expert MoE layer is not ported yet (ROADMAP "
                "Queue 1)")
        self.input_layernorm = RMSNorm(hidden_size)
        self.self_attn = HybridAttention(hidden_size, num_heads, head_dim)
        self.post_attention_layernorm = RMSNorm(hidden_size)
        self.mlp = GatedMLP(hidden_size, intermediate_size)

    def forward(self, x, mask, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), mask, cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class Transformer(nn.Module):
    """HCodec's in-codec transformer: N hybrid layers sharing one RoPE
    table, full attention or causal. (B, T, C) -> (B, T, C)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_heads: int, num_layers: int, use_moe: bool = False,
                 causal: bool = False):
        super().__init__()
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.layers = nn.ModuleList([
            TransformerLayer(hidden_size, intermediate_size, num_heads,
                             self.head_dim, use_moe)
            for _ in range(num_layers)])

    def forward(self, x):
        t = x.shape[1]
        cos, sin = rope_cos_sin(torch.arange(t, device=x.device),
                                self.head_dim)
        mask = causal_mask(t, device=x.device) if self.causal else None
        for layer in self.layers:
            x = layer(x, mask, cos, sin)
        return x
