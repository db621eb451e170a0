"""Transformer primitives: RoPE, RMSNorm, the gated MLP, attention and the
HCodec hybrid LSTM-attention transformer.

Port of ``unified_audio_tpu/nn/transformer.py`` (``rope_cos_sin``,
``rotate_half``, ``apply_rope``, ``RMSNorm``, ``GatedMLP``, ``MoE``,
``causal_mask``, ``sliding_window_mask``, ``attend``, ``HybridAttention``,
``TransformerLayer``, ``Transformer``), with the port's own
``grouped_mm`` (the routed experts' grouped GEMM). Layouts follow the JAX
package: q/k
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

from ..utils.profiling import span
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


def rope_rotate(x, cos, sin):
    """x: (B, T, H, D); cos/sin: (T, D) or (B, T, D), fp32 -> x rotated,
    in x's dtype (the rotation runs in fp32)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (x * cos + rotate_half(x) * sin).to(x.dtype)


def apply_rope(q, k, cos, sin):
    """q, k: (B, T, H, D); cos/sin: (T, D) or (B, T, D), fp32.

    The rotation runs in fp32 and the results are cast back to q/k's dtype,
    so a bf16 model stays bf16 downstream of the attention."""
    return rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)


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


def grouped_mm(x, w, ends):
    """Rows ``x`` (R, K) sorted into G runs times their run's matrix of
    ``w`` (G, K, N) -> (R, N) in x's dtype; ``ends`` (G,) int32 holds
    where each run ends (a run may be empty). ``torch._grouped_mm`` (one
    grouped GEMM, no host read: a CUDA graph captures it) where the build
    has it for the operands (bf16 on the card, any dtype on the CPU);
    elsewhere one product per run, the run ends read on the host."""
    if hasattr(torch, "_grouped_mm") and (
            not x.is_cuda or x.dtype == torch.bfloat16):
        return torch._grouped_mm(x, w, offs=ends)
    out, start = [], 0
    for j, end in enumerate(ends.tolist()):
        out.append(x[start:end] @ w[j])
        start = end
    return torch.cat(out)


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
    """Routed experts plus a shared expert (``GatedMLP``). The router runs
    in fp32 whatever the weights' dtype (DeepSeek-V3's ``MoEGate``): the
    gate is a softmax or a sigmoid of ``gate_linear``; the top
    ``n_activated`` experts are chosen on the scores plus ``gate_bias``,
    and weighted by the scores without it (renormalized over the chosen
    ones for the sigmoid), times ``route_scale``.

    Dispatch is routed: each token runs through its chosen experts only.
    The (token, expert) pairs are sorted by expert, so each expert's tokens
    sit in one run of rows; three grouped GEMMs (``grouped_mm``) take
    every run through its expert at once, in the stack's dtype, with no
    host read, so prefill and a CUDA-graph-captured decode step share the
    one path; each token's outputs are summed in fp32 under its weights.
    The JAX package dispatches densely (every expert on every token,
    combined by one-hot weights): the same sums, taken in another order.

    Expert parallelism: when ``parallel/mesh.py shard_lm_`` has cut the
    expert axis of ``expert_w*`` over tp (``tp_dim`` 0) and set
    ``tp_group``, a rank routes over all the experts, runs its E / tp
    experts on the rows routed to them (their span read on the host), and
    the partial outputs are summed over the group; the gate and the shared
    expert run replicated and are added once. The experts' input and the
    routing weights pass ``copy_to_group``, so the backward sums their
    partial gradients and every rank holds the whole gradient of the gate
    and of the input."""

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

    def route(self, x):
        """-> (experts (..., k) long, weights (..., k) fp32) of each token
        of x: the router in fp32."""
        scores = F.linear(x.float(), self.gate_linear.weight.float())
        scores = (torch.softmax(scores, dim=-1)
                  if self.score_func == "softmax" else torch.sigmoid(scores))
        top = top_k_indices(scores + self.gate_bias.float(), self.top_k)
        weights = scores.gather(-1, top)
        if self.score_func == "sigmoid":
            weights = weights / weights.sum(dim=-1, keepdim=True)
        return top, weights * self.route_scale

    def combine_weights(self, x):
        """(..., E) weights of the experts for each token of x (zero for
        the experts not chosen)."""
        top, weights = self.route(x)
        e = self.gate_bias.shape[0]
        return (F.one_hot(top, e) * weights[..., None]).sum(-2)

    def experts(self, xs, counts, first: int = 0):
        """The rows ``xs`` (R, D), sorted by expert with ``counts`` (E,)
        int32 rows an expert, through this rank's experts (global indices
        from ``first``; rows routed to other ranks' experts stay zero) ->
        (R, D) in xs's dtype."""
        n, rows = self.expert_w1.shape[0], xs.shape[0]
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        lo = hi = None
        if n != counts.shape[0]:  # an expert-parallel share
            lo = int(ends[first - 1]) if first else 0
            hi = int(ends[first + n - 1])
            xs, ends = xs[lo:hi], ends[first:first + n] - lo
        h = F.silu(grouped_mm(xs, self.expert_w1, ends)) * grouped_mm(
            xs, self.expert_w3, ends)
        y = grouped_mm(h, self.expert_w2, ends)
        if lo is None:
            return y
        out = y.new_zeros((rows, y.shape[1]))
        out[lo:hi] = y
        return out

    def forward(self, x):
        """x (..., D): the router reads it in fp32, the experts in its
        dtype (the stack's); the result in x's dtype."""
        with span("lm.moe"):
            xe = x.reshape(-1, x.shape[-1])
            group, first = None, 0
            with span("lm.moe.route"):
                top, w = self.route(xe)
                k = top.shape[-1]
                if getattr(self.expert_w1, "tp_dim", None) == 0:
                    # parallel/ imports this module: its collectives come
                    # late
                    from ..parallel.mesh import copy_to_group

                    group = self.tp_group
                    first = (self.expert_w1.shape[0]
                             * torch.distributed.get_rank(group))
                    # one tensor, so the backward sums both gradients in
                    # one collective whatever order the rank's own graph
                    # (its experts' share of the rows) reaches them in
                    xw = copy_to_group(torch.cat([xe.float(), w], -1), group)
                    xe, w = xw[:, :-k].to(x.dtype), xw[:, -k:]
                flat = top.reshape(-1)
                order = torch.argsort(flat, stable=True)
                counts = torch.zeros(self.gate_bias.shape[0],
                                     dtype=torch.int32, device=x.device)
                counts.index_add_(0, flat, torch.ones_like(
                    flat, dtype=torch.int32))
                xs, w = xe[order // k], w.reshape(-1)[order]
            with span("lm.moe.experts"):
                ys = self.experts(xs, counts, first).float() * w[:, None]
                y = torch.empty_like(ys).index_copy_(0, order, ys)
                y = y.view(-1, k, y.shape[-1]).sum(1).to(x.dtype)
                if group is not None:
                    from ..parallel.mesh import reduce_from_group

                    y = reduce_from_group(y, group)
            with span("lm.moe.shared"):
                out = y.view(x.shape) + self.shared_expert(x)
        return out


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
