"""Sequence-parallel (SP) prefill of the Llama stack.

Port of ``unified_audio_tpu/parallel/sequence.py``: the time axis is cut
over an ``sp`` mesh axis, each rank projects q/k/v from its own chunk of
positions (RoPE at their global positions), and the keys and values are
all-gathered over sp, in rank order, which is sequence order, so every
rank attends its queries against the whole causal prefix: the
all-gather-KV form of sequence parallelism. Forward only, as in the JAX
package; the layers are the model's own (``LlamaBackbone.layers``).
"""
from __future__ import annotations

import torch

from ..nn.transformer import apply_rope, rope_cos_sin
from .mesh import axis_group, axis_rank, axis_size, unshard_tensor

NEG_INF = -1e9


def _gather_time(x, group):
    """(B, S_local, ...) on every rank -> (B, S, ...) in rank order."""
    return x if group is None else unshard_tensor(x, 1, group)


@torch.no_grad()
def llama_sequence_parallel_forward(backbone, embeds, mesh, axis: str = "sp"):
    """The causal forward of ``backbone``'s layer stack (a
    ``LlamaBackbone``), sequence-sharded over ``axis``.

    ``embeds`` (B, S, D), the same on every rank, S divisible by the axis
    size. Returns the hidden states before the final norm (B, S, D) on
    every rank (each rank computes its chunk; the chunks are gathered at
    the end)."""
    sp, group = axis_size(mesh, axis), axis_group(mesh, axis)
    b, s, _ = embeds.shape
    if s % sp:
        raise ValueError(f"sequence {s} not divisible by {axis}={sp}")
    cfg = backbone.cfg
    sl = s // sp
    offset = axis_rank(mesh, axis) * sl
    dev = embeds.device
    pos = offset + torch.arange(sl, device=dev)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    key_pos = torch.arange(s, device=dev)
    mask = torch.where(key_pos[None] <= pos[:, None], 0.0, NEG_INF)
    x = embeds[:, offset:offset + sl]
    hd = cfg.head_dim
    for layer in backbone.layers:
        attn = layer.self_attn
        h = attn.local_heads
        q, k, v = (t.view(b, sl, h, hd) for t in attn.project_in(
            layer.input_layernorm(x)))
        q, k = apply_rope(q, k, cos, sin)
        k, v = _gather_time(k, group), _gather_time(v, group)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
        probs = torch.softmax(logits + mask, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, sl, -1)
        x = x + attn.project_out(out)
        x = x + layer.mlp(layer.post_attention_layernorm(x))
    return _gather_time(x, group)
