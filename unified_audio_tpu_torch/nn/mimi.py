"""The Mimi (Kyutai) transformer of the HCodec-1.5 line, offline.

Port of ``unified_audio_tpu/nn/mimi.py``: ``rope_interleaved``,
``MimiTransformerLayer``, ``MimiTransformer`` and
``MimiProjectedTransformer``, the stacks of HCodec-1.5's query-token
aggregators and decode bottleneck and of FlexiCodec's aligned mode. With
``causal=False`` (every shipped config) a layer attends over the whole
sequence; an additive key-validity mask takes static-shape padding out of
attention, and ``context`` only shapes the causal mask.

A layer: pre-LN (eps 1e-5) attention with the fused ``in_proj`` (3D x D,
no bias, packed p-major: (B, S, 3, H, hd)), interleaved-pair RoPE on q and
k, logits in the activation dtype, softmax in fp32, ``out_proj`` (no
bias), LayerScale; then pre-LN erf-GELU MLP (``linear1``/``linear2``, no
bias), LayerScale. Parameter names follow the reference layout that
``export_hcodec15_state_dict`` writes (``layers.{i}.self_attn.
in_proj_weight``, ``self_attn.out_proj.weight``, ``layer_scale_1.scale``).
The layers are a plain ``nn.ModuleList``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .transformer import NEG_INF


def rope_tables(positions, head_dim: int, max_period: float = 10000.0):
    """(cos, sin) of the angles of ``positions`` (S,), each (1, S, 1,
    head_dim / 2) fp32. A stack builds them once and shares them across
    its layers."""
    if head_dim % 2:
        raise ValueError(f"rope head_dim must be even, got {head_dim}")
    ds = torch.arange(head_dim // 2, dtype=torch.float32,
                      device=positions.device)
    freqs = torch.exp(ds * (-math.log(max_period) * 2.0 / head_dim))
    angles = positions.float()[:, None] * freqs  # (S, D/2)
    return torch.cos(angles)[None, :, None], torch.sin(angles)[None, :, None]


def _rotate(x, rotr, roti):
    """x (B, S, H, D): rotate interleaved (even, odd) pairs by the tables
    of :func:`rope_tables`, in fp32; the result in x's dtype."""
    xr, xi = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([xr * rotr - xi * roti, xr * roti + xi * rotr], -1)
    return out.reshape(x.shape).to(x.dtype)


def rope_interleaved(x, positions, max_period: float = 10000.0):
    """Rotate interleaved (even, odd) pairs of x (B, S, H, D) by the angles
    of ``positions`` (S,), in fp32; the result in x's dtype."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], max_period))


class LayerScale(nn.Module):
    """A per-channel scale at ``scale`` (the reference's name)."""

    def __init__(self, dim: int, init: float):
        super().__init__()
        self.scale = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.scale


class MimiAttention(nn.Module):
    """The fused q/k/v projection and the output projection, no biases."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.out_proj = nn.Linear(d_model, d_model, bias=False)


def attention_mask(s: int, key_valid=None, causal: bool = False,
                   context: Optional[int] = None, device=None,
                   dtype=torch.float32):
    """The additive (B or 1, 1, S, S) mask: NEG_INF where a key is not
    visible (past ``context`` or in the future under ``causal``, or not in
    ``key_valid`` (B, S))."""
    mask = torch.zeros(1, 1, s, s, dtype=dtype, device=device)
    if causal:
        pos = torch.arange(s, device=device)
        delta = pos[:, None] - pos[None, :]
        vis = delta >= 0
        if context is not None:
            vis &= delta < context
        mask = torch.where(vis, 0.0, NEG_INF).to(dtype)[None, None]
    if key_valid is not None:
        mask = mask + torch.where(key_valid, 0.0, NEG_INF).to(dtype)[
            :, None, None, :]
    return mask


class MimiTransformerLayer(nn.Module):
    """One StreamingTransformerLayer, offline; x (B, S, D), ``mask`` the
    additive mask of :func:`attention_mask`, ``rope`` the (cos, sin) of
    :func:`rope_tables` for positions 0..S-1."""

    def __init__(self, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048,
                 layer_scale: Optional[float] = 0.01):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = MimiAttention(d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward, bias=False)
        self.linear2 = nn.Linear(dim_feedforward, d_model, bias=False)
        if layer_scale is not None:
            self.layer_scale_1 = LayerScale(d_model, layer_scale)
            self.layer_scale_2 = LayerScale(d_model, layer_scale)
        else:
            self.layer_scale_1 = self.layer_scale_2 = nn.Identity()

    def forward(self, x, mask, rope):
        b, s, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = F.linear(self.norm1(x), self.self_attn.in_proj_weight)
        qkv = qkv.reshape(b, s, 3, h, hd)  # p-major packing
        q = _rotate(qkv[:, :, 0], *rope)
        k = _rotate(qkv[:, :, 1], *rope)
        v = qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        probs = torch.softmax((logits + mask.to(logits.dtype)).float(),
                              -1).to(x.dtype)
        attended = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
        x = x + self.layer_scale_1(self.self_attn.out_proj(attended))
        ff = self.linear2(F.gelu(self.linear1(self.norm2(x))))
        return x + self.layer_scale_2(ff)


class MimiTransformer(nn.Module):
    """``num_layers`` Mimi layers under one mask."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int = 8,
                 dim_feedforward: int = 2048, causal: bool = False,
                 context: Optional[int] = None,
                 layer_scale: Optional[float] = 0.01):
        super().__init__()
        self.causal, self.context = causal, context
        self.head_dim = d_model // num_heads
        self.layers = nn.ModuleList([
            MimiTransformerLayer(d_model, num_heads, dim_feedforward,
                                 layer_scale) for _ in range(num_layers)])

    def forward(self, x, key_valid=None):
        """x (B, S, D); ``key_valid`` (B, S) bool marks the positions that
        exist (static-shape padding is kept out of attention)."""
        mask = attention_mask(x.shape[1], key_valid, self.causal,
                              self.context, x.device)
        rope = rope_tables(torch.arange(x.shape[1], device=x.device),
                           self.head_dim)
        for layer in self.layers:
            x = layer(x, mask, rope)
        return x


class MimiProjectedTransformer(nn.Module):
    """ProjectedTransformer: no-bias input/output projections around the
    stack (identity when the widths match, as in every shipped config).
    Channels-last (B, T, C)."""

    def __init__(self, d_model: int, input_dim: int, output_dim: int,
                 num_layers: int, num_heads: int = 8,
                 dim_feedforward: int = 2048, causal: bool = False,
                 context: Optional[int] = None,
                 layer_scale: Optional[float] = 0.01):
        super().__init__()
        if input_dim != d_model:
            self.input_proj = nn.Linear(input_dim, d_model, bias=False)
        self.transformer = MimiTransformer(
            d_model, num_layers, num_heads, dim_feedforward, causal, context,
            layer_scale)
        if output_dim != d_model:
            self.output_proj = nn.Linear(d_model, output_dim, bias=False)

    def forward(self, x, key_valid=None):
        if hasattr(self, "input_proj"):
            x = self.input_proj(x)
        x = self.transformer(x, key_valid)
        if hasattr(self, "output_proj"):
            x = self.output_proj(x)
        return x
