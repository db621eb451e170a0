"""The conformer condition encoder.

Port of ``unified_audio_tpu/models/lm/conformer.py``: rotary-embedding
conformer blocks (half-FFN -> MHSA -> depthwise-conv module -> half-FFN ->
LN) and the MM-DiT joint attention. The reference builds the encoder as
the mel-conditioning encoder of its LM but ``LLMSFT`` bypasses it, so the
port's LM does not build one (``cli.load_lm`` ignores a checkpoint's
``conformer.*`` keys); it is here as a module of its own.

Parameter names are the JAX package's with ``layers_{i}`` as
``layers.{i}`` (``utils/convert.py conformer_state_dict`` maps them):
``ff1.{norm,ff1,ff2}``, ``attn.{norm,to_q,to_k,to_v,to_out}``,
``conv.{norm,pw1,dwconv.conv,dwnorm,pw2}``, ``ff2``, ``post_norm``. The
LayerNorms take flax's epsilon, 1e-6.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...nn.conv import CausalConv1d
from ...nn.transformer import apply_rope, attend, rope_cos_sin

EPS = 1e-6  # flax LayerNorm's epsilon


class ConformerFeedForward(nn.Module):
    """LN -> Linear (dim * mult) -> SiLU -> Linear (dim)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.ff1 = nn.Linear(dim, dim * mult)
        self.ff2 = nn.Linear(dim * mult, dim)

    def forward(self, x):
        return self.ff2(F.silu(self.ff1(self.norm(x))))


class ConformerConvModule(nn.Module):
    """LN -> pointwise GLU -> depthwise conv (non-causal, zero pad) ->
    LN -> SiLU -> pointwise."""

    def __init__(self, dim: int, kernel_size: int = 31):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.pw1 = nn.Linear(dim, dim * 2)
        self.dwconv = CausalConv1d(dim, dim, kernel_size, causal=False,
                                   groups=dim)
        self.dwnorm = nn.LayerNorm(dim, eps=EPS)
        self.pw2 = nn.Linear(dim, dim)

    def forward(self, x):
        a, b = self.pw1(self.norm(x)).chunk(2, dim=-1)
        h = self.dwconv(a * torch.sigmoid(b))
        return self.pw2(F.silu(self.dwnorm(h)))


class ConformerAttention(nn.Module):
    """LN -> q/k/v (no bias) -> RoPE -> softmax attention -> ``to_out``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, cos, sin):
        b, t, _ = x.shape
        h = self.norm(x)
        shape = (b, t, self.heads, self.dim_head)
        q, k = apply_rope(self.to_q(h).view(shape), self.to_k(h).view(shape),
                          cos, sin)
        out = attend(q, k, self.to_v(h).view(shape), None,
                     self.dim_head ** -0.5)
        return self.to_out(out.reshape(b, t, -1))


class JointAttention(nn.Module):
    """MM-DiT joint attention: the sample stream ``x`` (B, N, dim) and the
    context stream ``c`` (B, Nt, dim) have their own q/k/v projections,
    attend jointly over the concatenated sequence, and split back to their
    own output projections. ``rope``/``c_rope`` ((cos, sin) or None)
    rotate each stream by its own positions; ``mask`` (B, N) bool masks
    padded sample positions as keys and zeroes their outputs (the context
    is never masked). -> (x_out, c_out); c_out is None with
    ``context_pre_only``, which builds no ``to_out_c``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 context_pre_only: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        for name in ("to_q", "to_k", "to_v", "to_q_c", "to_k_c", "to_v_c"):
            setattr(self, name, nn.Linear(dim, inner, bias=False))
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.to_out_c = (None if context_pre_only
                         else nn.Linear(inner, dim, bias=False))

    def forward(self, x, c, mask=None, rope=None, c_rope=None):
        b, n, _ = x.shape
        nt = c.shape[1]

        def proj(layer, y, t):
            return layer(y).view(b, t, self.heads, self.dim_head)

        q, k, v = (proj(self.to_q, x, n), proj(self.to_k, x, n),
                   proj(self.to_v, x, n))
        cq, ck, cv = (proj(self.to_q_c, c, nt), proj(self.to_k_c, c, nt),
                      proj(self.to_v_c, c, nt))
        if rope is not None:
            q, k = apply_rope(q, k, *rope)
        if c_rope is not None:
            cq, ck = apply_rope(cq, ck, *c_rope)
        q, k, v = (torch.cat([q, cq], 1), torch.cat([k, ck], 1),
                   torch.cat([v, cv], 1))
        attn_mask = None
        if mask is not None:
            keep = torch.cat([mask, mask.new_ones((b, nt))], dim=1)
            attn_mask = torch.where(keep, 0.0, -1e9)[:, None, None, :]
        out = attend(q, k, v, attn_mask, self.dim_head ** -0.5)
        out = out.reshape(b, n + nt, -1)
        x_out = self.to_out(out[:, :n])
        if mask is not None:
            x_out = torch.where(mask[..., None], x_out, 0.0)
        c_out = None if self.to_out_c is None else self.to_out_c(out[:, n:])
        return x_out, c_out


class ConformerLayer(nn.Module):
    """x + ff1 / 2, + attention, + conv module, + ff2 / 2, then LN."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 ff_mult: int = 4, conv_kernel: int = 31):
        super().__init__()
        self.ff1 = ConformerFeedForward(dim, ff_mult)
        self.attn = ConformerAttention(dim, heads, dim_head)
        self.conv = ConformerConvModule(dim, conv_kernel)
        self.ff2 = ConformerFeedForward(dim, ff_mult)
        self.post_norm = nn.LayerNorm(dim, eps=EPS)

    def forward(self, x, cos, sin):
        x = x + 0.5 * self.ff1(x)
        x = x + self.attn(x, cos, sin)
        x = x + self.conv(x)
        x = x + 0.5 * self.ff2(x)
        return self.post_norm(x)


class ConformerEncoder(nn.Module):
    """``num_layers`` conformer layers sharing one rotary table (UniSE's
    configuration: 6 layers, d = 512, 8 heads, dh = 64). (B, T, dim) ->
    (B, T, dim)."""

    def __init__(self, num_layers: int = 6, dim: int = 512, heads: int = 8,
                 dim_head: int = 64, ff_mult: int = 4,
                 depthwise_conv_kernel_size: int = 31):
        super().__init__()
        self.dim_head = dim_head
        self.layers = nn.ModuleList([
            ConformerLayer(dim, heads, dim_head, ff_mult,
                           depthwise_conv_kernel_size)
            for _ in range(num_layers)])

    def forward(self, x):
        cos, sin = rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                                self.dim_head)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return x
