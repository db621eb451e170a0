"""Streaming transformer with a ring KV cache.

Port of ``unified_audio_tpu/nn/streaming.py`` (the Kyutai/Mimi streaming
stack's state protocol, ring KV cache, streaming attention and projected
transformer) with the state passed explicitly:

* The state is a dict of tensors (:func:`init_ring_state`): the ring's
  keys and values (L, B, C, H, hd), the absolute position written into
  each slot (L, C; -1 = empty) and ``end``, the next absolute position.
  ``step`` returns a new state and leaves the one it was given untouched.
* The ring holds the last ``capacity`` keys; a query at position p sees
  the slots whose position q has 0 <= p - q < ``context``.
* ``forward`` (offline) equals feeding the same sequence chunk by chunk
  through ``step`` whenever the ring holds the chunk and the context
  before its first frame: capacity >= context + chunk - 1 (the Mimi
  invariant; for chunks of 1, capacity >= context). ``step`` refuses a
  chunk that does not fit so: its first queries would need keys the chunk
  itself overwrites. (The JAX package states the invariant for capacity
  >= context whatever the chunk and computes such chunks regardless, to a
  different result.)

Logits are computed in the activation dtype, the softmax in fp32, as in
the JAX package. Parameter names follow the JAX package's
(``layers.{i}.self_attn.{q,k,v,o}_proj``, ``norm1``, ``norm2``,
``gating.{w1,w2,w3}``; ``proj_in``, ``core``, ``proj_out``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .transformer import (NEG_INF, GatedMLP, RMSNorm, apply_rope,
                          rope_cos_sin, sliding_window_mask)


def init_ring_state(num_layers: int, batch: int, capacity: int,
                    num_heads: int, head_dim: int, dtype=torch.float32,
                    device=None):
    """An empty ring: zero keys and values, every slot's position -1,
    ``end`` 0."""
    shape = (num_layers, batch, capacity, num_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((num_layers, capacity), -1, dtype=torch.long,
                          device=device),
        "end": torch.zeros((), dtype=torch.long, device=device),
    }


def _attend(q, k, v, mask, scale: float):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class StreamingAttention(nn.Module):
    """Causal attention over the sliding window (offline) or over a ring
    of past keys (streaming)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context: int):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.context = context
        inner = num_heads * head_dim
        self.q_proj = nn.Linear(dim, inner, bias=False)
        self.k_proj = nn.Linear(dim, inner, bias=False)
        self.v_proj = nn.Linear(dim, inner, bias=False)
        self.o_proj = nn.Linear(inner, dim, bias=False)

    def forward(self, x, layer_state=None, end=None):
        """x (B, S, D). Offline when ``layer_state`` is None; else
        ``layer_state`` = (k_buf, v_buf, pos_buf) of this layer and ``end``
        the chunk's first absolute position: the chunk's keys are written
        into the ring and the queries attend over it. -> (out, new
        layer state or None)."""
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        scale = self.head_dim ** -0.5
        if layer_state is None:
            cos, sin = rope_cos_sin(torch.arange(s, device=x.device),
                                    self.head_dim)
            q, k = apply_rope(q, k, cos, sin)
            mask = sliding_window_mask(s, self.context, device=x.device)
            out, new_state = _attend(q, k, v, mask, scale), None
        else:
            k_buf, v_buf, pos_buf = layer_state
            capacity = k_buf.shape[1]
            if self.context + s - 1 > capacity:
                raise ValueError(
                    f"a chunk of {s} frames does not fit a ring of "
                    f"{capacity} at context {self.context}: it needs "
                    f"{self.context + s - 1} slots")
            positions = end + torch.arange(s, device=x.device)
            cos, sin = rope_cos_sin(positions, self.head_dim)
            q, k = apply_rope(q, k, cos, sin)
            slots = positions % capacity
            k_buf = k_buf.index_copy(1, slots, k)
            v_buf = v_buf.index_copy(1, slots, v)
            pos_buf = pos_buf.index_copy(0, slots, positions)
            delta = positions[:, None] - pos_buf[None, :]  # (S, C)
            visible = (delta >= 0) & (delta < self.context) & (pos_buf >= 0)
            mask = torch.where(visible, 0.0, NEG_INF)
            out = _attend(q, k_buf, v_buf, mask, scale)
            new_state = (k_buf, v_buf, pos_buf)
        return self.o_proj(out.reshape(b, s, -1)), new_state


class StreamingTransformerLayer(nn.Module):
    """RMSNorm -> streaming attention, RMSNorm -> gated MLP (4 * dim),
    each residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context: int):
        super().__init__()
        self.norm1 = RMSNorm(dim)
        self.self_attn = StreamingAttention(dim, num_heads, head_dim, context)
        self.norm2 = RMSNorm(dim)
        self.gating = GatedMLP(dim, dim * 4)

    def forward(self, x, layer_state=None, end=None):
        h, new_state = self.self_attn(self.norm1(x), layer_state, end)
        x = x + h
        return x + self.gating(self.norm2(x)), new_state


class StreamingTransformer(nn.Module):
    """Context-limited streaming transformer with gated FFNs (Mimi's
    configuration: context 16)."""

    def __init__(self, dim: int, num_layers: int = 4, num_heads: int = 8,
                 context: int = 16):
        super().__init__()
        self.num_layers, self.num_heads, self.context = (num_layers,
                                                         num_heads, context)
        self.head_dim = dim // num_heads
        self.layers = nn.ModuleList([
            StreamingTransformerLayer(dim, num_heads, self.head_dim, context)
            for _ in range(num_layers)])

    def forward(self, x):
        for layer in self.layers:
            x, _ = layer(x)
        return x

    def init_state(self, batch: int, capacity: Optional[int] = None,
                   dtype=None, device=None):
        """An empty ring of ``capacity`` (default ``context``) slots, in
        the weights' dtype and device unless told otherwise."""
        w = self.layers[0].self_attn.q_proj.weight
        return init_ring_state(self.num_layers, batch,
                               capacity or self.context, self.num_heads,
                               self.head_dim, dtype or w.dtype,
                               device or w.device)

    def step(self, x, state):
        """A chunk (B, S, D) -> (out, new state)."""
        end = state["end"]
        ks, vs, ps = [], [], []
        for i, layer in enumerate(self.layers):
            x, (k, v, p) = layer(
                x, (state["k"][i], state["v"][i], state["pos"][i]), end)
            ks.append(k)
            vs.append(v)
            ps.append(p)
        return x, {"k": torch.stack(ks), "v": torch.stack(vs),
                   "pos": torch.stack(ps), "end": end + x.shape[1]}


class ProjectedStreamingTransformer(nn.Module):
    """Input and output projections (no bias) around the streaming core."""

    def __init__(self, dim: int, input_dim: int, output_dim: int,
                 num_layers: int = 4, num_heads: int = 8, context: int = 16):
        super().__init__()
        self.proj_in = nn.Linear(input_dim, dim, bias=False)
        self.core = StreamingTransformer(dim, num_layers, num_heads, context)
        self.proj_out = nn.Linear(dim, output_dim, bias=False)

    def forward(self, x):
        return self.proj_out(self.core(self.proj_in(x)))

    def init_state(self, batch: int, capacity: Optional[int] = None,
                   dtype=None, device=None):
        return self.core.init_state(batch, capacity, dtype, device)

    def step(self, x, state):
        h, state = self.core.step(self.proj_in(x), state)
        return self.proj_out(h), state
