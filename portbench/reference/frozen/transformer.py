# Frozen copy of unified_audio_tpu_torch/nn/transformer.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""Transformer primitives: RoPE, RMSNorm, the gated MLP, attention and the
HCodec hybrid LSTM-attention transformer.

Port of ``unified_audio_tpu/nn/transformer.py`` (``rope_cos_sin``,
``rotate_half``, ``apply_rope``, ``RMSNorm``, ``GatedMLP``, ``MoE``,
``causal_mask``, ``sliding_window_mask``, ``attend``, ``HybridAttention``,
``TransformerLayer``, ``Transformer``). Layouts follow the JAX package: q/k
are (B, T, H, D). Parameter names follow the reference layout
(``self_attn.rnn.weight_ih_l0``, ``self_attn.q_proj``, ``mlp.w1``,
``input_layernorm.weight``); the routed experts keep the JAX package's
names and stacked layout (``mlp.expert_w1`` (E, D, I), ``mlp.gate_linear``,
``mlp.gate_bias``, ``mlp.shared_expert.w1``).
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


def top_k_indices(scores, k: int):
    """The indices of the ``k`` largest entries of the last axis, largest
    first; among equal entries the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


class MoE(nn.Module):
    """Routed experts plus a shared expert (``GatedMLP``). The gate is a
    softmax (fp32) or a sigmoid of ``gate_linear``; the top ``n_activated``
    experts are chosen on the scores plus ``gate_bias``, and weighted by
    the scores without it (renormalized over the chosen ones for the
    sigmoid), times ``route_scale``. Dispatch is dense, as in the JAX
    package: every expert runs on every token, the outputs are combined
    by one-hot weights.

    Expert parallelism: when ``parallel/mesh.py shard_lm_`` has cut the
    expert axis of ``expert_w*`` over tp (``tp_dim`` 0) and set
    ``tp_group``, a rank runs its E / tp experts on its slice of the
    combine weights and the partial outputs are summed over the group; the
    gate and the shared expert run replicated and are added once. The
    experts' input and the combine weights pass ``copy_to_group``, so the
    backward sums their partial gradients and every rank holds the whole
    gradient of the gate and of the input."""

    def __init__(self, dim: int, inter_dim: int, n_routed_experts: int = 3,
                 n_activated_experts: int = 1, n_shared_experts: int = 1,
                 route_scale: float = 1.0, score_func: str = "softmax"):
        super().__init__()
        if score_func not in ("softmax", "sigmoid"):
            raise ValueError(f"score_func {score_func!r}: 'softmax' or "
                             "'sigmoid'")
        e = n_routed_experts
        self.top_k, self.route_scale = n_activated_experts, route_scale
        self.score_func = score_func
        self.gate_linear = nn.Linear(dim, e, bias=False)
        self.gate_bias = nn.Parameter(torch.zeros(e))
        self.expert_w1 = nn.Parameter(torch.empty(e, dim, inter_dim))
        self.expert_w3 = nn.Parameter(torch.empty(e, dim, inter_dim))
        self.expert_w2 = nn.Parameter(torch.empty(e, inter_dim, dim))
        for w in (self.expert_w1, self.expert_w3, self.expert_w2):
            nn.init.normal_(w, std=w.shape[1] ** -0.5)
        self.shared_expert = GatedMLP(dim, n_shared_experts * inter_dim)
        self.tp_group = None

    def combine_weights(self, x):
        """(..., E) weights of the experts for each token of x."""
        scores = self.gate_linear(x)
        scores = (torch.softmax(scores.float(), dim=-1)
                  if self.score_func == "softmax" else torch.sigmoid(scores))
        top = top_k_indices(scores + self.gate_bias, self.top_k)
        onehot = F.one_hot(top, scores.shape[-1]).to(x.dtype)  # (..., k, E)
        weights = (onehot * scores[..., None, :].to(x.dtype)).sum(-1)
        if self.score_func == "sigmoid":
            weights = weights / weights.sum(dim=-1, keepdim=True)
        weights = weights * self.route_scale
        return (onehot * weights[..., None]).sum(-2)

    def forward(self, x):
        combine = self.combine_weights(x)
        xe = x
        split = getattr(self.expert_w1, "tp_dim", None) == 0
        if split:
            # parallel/ imports this module: its collectives come late
            from ..parallel.mesh import copy_to_group, reduce_from_group

            n = self.expert_w1.shape[0]
            r = torch.distributed.get_rank(self.tp_group)
            xe = copy_to_group(x, self.tp_group)
            combine = copy_to_group(combine, self.tp_group)[
                ..., r * n:(r + 1) * n]
        h = F.silu(torch.einsum("...d,edi->...ei", xe, self.expert_w1)) * \
            torch.einsum("...d,edi->...ei", xe, self.expert_w3)
        y_e = torch.einsum("...ei,eid->...ed", h, self.expert_w2)
        y = torch.einsum("...ed,...e->...d", y_e, combine)
        if split:
            y = reduce_from_group(y, self.tp_group)
        return y + self.shared_expert(x)


def causal_mask(t: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(T, T) additive mask: 0 where visible, NEG_INF above the diagonal."""
    row = torch.arange(t, device=device)[:, None]
    col = torch.arange(t, device=device)[None, :]
    return torch.where(col <= row, 0.0, NEG_INF).to(dtype)


def sliding_window_mask(t: int, left_context: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """(T, T) additive causal mask limited to the ``left_context`` latest
    positions (the query's own included)."""
    row = torch.arange(t, device=device)[:, None]
    col = torch.arange(t, device=device)[None, :]
    visible = (col <= row) & (col > row - left_context)
    return torch.where(visible, 0.0, NEG_INF).to(dtype)


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
    """Pre-norm hybrid attention, then the gated MLP or, with ``use_moe``,
    the routed experts (``moe_experts``, top ``moe_topk``)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_heads: int, head_dim: int, use_moe: bool = False,
                 moe_experts: int = 3, moe_topk: int = 1):
        super().__init__()
        self.input_layernorm = RMSNorm(hidden_size)
        self.self_attn = HybridAttention(hidden_size, num_heads, head_dim)
        self.post_attention_layernorm = RMSNorm(hidden_size)
        self.mlp = (MoE(hidden_size, intermediate_size, moe_experts, moe_topk)
                    if use_moe else GatedMLP(hidden_size, intermediate_size))

    def forward(self, x, mask, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), mask, cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class Transformer(nn.Module):
    """HCodec's in-codec transformer: N hybrid layers sharing one RoPE
    table, full attention or causal; a causal one with
    ``use_sliding_window`` sees only the ``left_context`` latest
    positions. (B, T, C) -> (B, T, C)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_heads: int, num_layers: int, use_moe: bool = False,
                 causal: bool = False, moe_experts: int = 3,
                 moe_topk: int = 1, use_sliding_window: bool = False,
                 left_context: int = 0):
        super().__init__()
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_sliding_window, self.left_context = (use_sliding_window,
                                                      left_context)
        self.layers = nn.ModuleList([
            TransformerLayer(hidden_size, intermediate_size, num_heads,
                             self.head_dim, use_moe, moe_experts, moe_topk)
            for _ in range(num_layers)])

    def forward(self, x):
        t = x.shape[1]
        cos, sin = rope_cos_sin(torch.arange(t, device=x.device),
                                self.head_dim)
        mask = None
        if self.causal:
            mask = (sliding_window_mask(t, self.left_context, device=x.device)
                    if self.use_sliding_window
                    else causal_mask(t, device=x.device))
        for layer in self.layers:
            x = layer(x, mask, cos, sin)
        return x
