"""Codec blocks on channels-last (B, T, C) tensors.

Port of the blocks of ``unified_audio_tpu/nn/blocks.py`` that BiCodec's
detokenize path and the HCodec-1.0 round trip run: ``AdaLayerNorm``,
``ConvNeXtBlock`` and ``ConvNeXtStack``, ``VocosBackbone``, ``SamplingBlock``
(ratio-1 path), ``Snake1d``, ``DACResidualUnit``, ``WaveDecoderBlock``,
``WaveGenerator``, ``swish``, ``ResnetBlock``, ``SEANetResnetBlock`` and
``SEANetEncoder``, each non-causal or causal (the HCodec convs' causal
zero or reflect pads, the transformer's causal mask). Submodule names follow the reference torch layouts
(``convnext.{i}.dwconv``, ``model.{i}.block.{j}``, Snake ``alpha`` (1, C, 1),
``post_net.{i}.pwconv1.linear``), the layouts ``export_bicodec_state_dict``
and ``export_hcodec10_state_dict`` write.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .conv import CausalConv1d, Conv1d, ConvTranspose1d, SConv1d, Wrapped
from .transformer import Transformer


def swish(x):
    return x * torch.sigmoid(x)


class AdaLayerNorm(nn.Module):
    """LayerNorm (no affine) whose scale and shift come from a condition
    vector (B, cond_dim)."""

    def __init__(self, cond_dim: int, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Linear(cond_dim, dim)
        self.shift = nn.Linear(cond_dim, dim)

    def forward(self, x, cond):
        x = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return x * self.scale(cond)[:, None] + self.shift(cond)[:, None]


class ConvNeXtBlock(nn.Module):
    """Depthwise k7 conv -> LN (or AdaLN) -> pointwise MLP -> gamma,
    residual. ``wrapped`` puts the weights where HCodec's reference keeps
    them (``dwconv.conv``, ``pwconv1.linear``, ``pwconv2.linear``); the
    k7 zero pad is HCodec's constant-pad conv: (3, 3), or (6, 0) when
    ``causal``. A ``layer_scale_init_value`` of None builds no gamma
    (FlexiCodec's adapters)."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init_value: Optional[float],
                 condition_dim: Optional[int] = None, wrapped: bool = False,
                 causal: bool = False):
        super().__init__()
        self.causal_pad = 6 if causal else 0
        self.dwconv = Conv1d(dim, dim, 7, groups=dim,
                             padding=0 if causal else 3)
        self.norm = (AdaLayerNorm(condition_dim, dim) if condition_dim
                     else nn.LayerNorm(dim, eps=1e-6))
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        if wrapped:
            self.dwconv = Wrapped("conv", self.dwconv)
            self.pwconv1 = Wrapped("linear", self.pwconv1)
            self.pwconv2 = Wrapped("linear", self.pwconv2)
        self.gamma = (None if layer_scale_init_value is None else
                      nn.Parameter(torch.full((dim,),
                                              layer_scale_init_value)))

    def forward(self, x, cond=None):
        h = self.dwconv(F.pad(x, (0, 0, self.causal_pad, 0))
                        if self.causal_pad else x)
        h = self.norm(h, cond) if isinstance(self.norm, AdaLayerNorm) \
            else self.norm(h)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + (h if self.gamma is None else self.gamma * h)


class VocosBackbone(nn.Module):
    """Embed conv k7 -> (Ada)LN -> N ConvNeXt blocks -> final LN."""

    def __init__(self, in_dim: int, dim: int, intermediate_dim: int,
                 num_layers: int, condition_dim: Optional[int] = None):
        super().__init__()
        self.embed = Conv1d(in_dim, dim, 7, padding=3)
        self.norm = (AdaLayerNorm(condition_dim, dim) if condition_dim
                     else nn.LayerNorm(dim, eps=1e-6))
        self.convnext = nn.ModuleList([
            ConvNeXtBlock(dim, intermediate_dim, 1.0 / num_layers,
                          condition_dim) for _ in range(num_layers)])
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, condition=None):
        x = self.embed(x)
        x = self.norm(x, condition) if isinstance(self.norm, AdaLayerNorm) \
            else self.norm(x)
        for block in self.convnext:
            x = block(x, condition)
        return self.final_layer_norm(x)


class SamplingBlock(nn.Module):
    """Learned resampler; only the ratio-1 path (BiCodec's configuration)
    is ported, where the conv and both skips are the input: 3 * x."""

    def __init__(self, upsample_scale: int = 1, downsample_scale: int = 1):
        super().__init__()
        if upsample_scale != 1 or downsample_scale != 1:
            raise NotImplementedError("only ratio-1 sampling blocks are "
                                      "ported (ROADMAP Queue 1)")

    def forward(self, x):
        return x + x + x


class Snake1d(nn.Module):
    """x + sin^2(alpha x) / alpha, alpha per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x):
        alpha = self.alpha.view(1, 1, -1)
        return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x).square()


class DACResidualUnit(nn.Module):
    """Snake -> conv k7 dilated (same pad) -> Snake -> conv k1, residual.
    ``weight_norm`` trains both convs as (g, v)."""

    def __init__(self, dim: int, dilation: int = 1,
                 weight_norm: bool = False):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        wn = dict(weight_norm=weight_norm)
        self.block = nn.ModuleList([
            Snake1d(dim),
            Conv1d(dim, dim, 7, dilation=dilation, padding=pad, **wn),
            Snake1d(dim), Conv1d(dim, dim, 1, padding=0, **wn)])

    def forward(self, x):
        y = x
        for m in self.block:
            y = m(y)
        return x + y


class WaveDecoderBlock(nn.Module):
    """Snake -> transposed conv (k, s, pad (k-s)//2) -> 3 dilated residual
    units."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int,
                 stride: int, weight_norm: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm)
        self.block = nn.ModuleList([
            Snake1d(input_dim),
            ConvTranspose1d(input_dim, output_dim, kernel_size, stride,
                            padding=(kernel_size - stride) // 2,
                            output_padding=0, **wn),
            *[DACResidualUnit(output_dim, d, **wn) for d in (1, 3, 9)]])

    def forward(self, x):
        for m in self.block:
            x = m(x)
        return x


class WaveGenerator(nn.Module):
    """DAC-style vocoder head: (B, T, input_channel) -> (B, T * prod(rates),
    d_out) in [-1, 1]. ``weight_norm`` trains every conv as (g, v)."""

    def __init__(self, input_channel: int, channels: int,
                 rates: Sequence[int], kernel_sizes: Sequence[int],
                 d_out: int = 1, weight_norm: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm)
        layers = [Conv1d(input_channel, channels, 7, padding=3, **wn)]
        dim = channels
        for i, (k, s) in enumerate(zip(kernel_sizes, rates)):
            out_dim = channels // 2 ** (i + 1)
            layers.append(WaveDecoderBlock(dim, out_dim, k, s, **wn))
            dim = out_dim
        layers += [Snake1d(dim), Conv1d(dim, d_out, 7, padding=3, **wn)]
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        for m in self.model:
            x = m(x)
        return torch.tanh(x)


class ConvNeXtStack(nn.ModuleList):
    """HCodec's stack of ConvNeXt blocks (``post_net.{i}``), gamma =
    1 / num_layers, non-causal or causal. The JAX package scans over
    stacked parameters; here the blocks are a list."""

    def __init__(self, dim: int, intermediate_dim: int, num_layers: int,
                 causal: bool = False):
        super().__init__([
            ConvNeXtBlock(dim, intermediate_dim, 1.0 / num_layers,
                          wrapped=True, causal=causal)
            for _ in range(num_layers)])

    def forward(self, x):
        for block in self:
            x = block(x)
        return x


# ---------------------------------------------------------------------------
# GroupNorm Resnet block, SEANet encoder (HCodec-1.0)
# ---------------------------------------------------------------------------

class GroupNorm(nn.GroupNorm):
    """``torch.nn.GroupNorm`` over channels-last (B, T, C) input."""

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ResnetBlock(nn.Module):
    """GroupNorm(32, eps 1e-6) -> swish -> conv k3, twice, residual (the
    width is kept, so no ``nin_shortcut``). ``causal`` pads the convs on
    the left only; the GroupNorm still takes its statistics over the whole
    time axis, as in the JAX package, so the block is not causal end to
    end."""

    def __init__(self, channels: int, causal: bool = False):
        super().__init__()
        self.norm1 = GroupNorm(32, channels, eps=1e-6)
        self.conv1 = CausalConv1d(channels, channels, 3, causal)
        self.norm2 = GroupNorm(32, channels, eps=1e-6)
        self.conv2 = CausalConv1d(channels, channels, 3, causal)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        # no dropout: the JAX package keeps it deterministic, in training too
        return x + self.conv2(swish(self.norm2(h)))


class SEANetResnetBlock(nn.Module):
    """ELU -> SConv k3 (dim -> dim / 2) -> ELU -> SConv k1 (back to dim),
    plus a 1x1 SConv shortcut (``true_skip=False``). Convs at ``block.1``,
    ``block.3`` and ``shortcut``."""

    def __init__(self, dim: int, weight_norm: bool = False,
                 causal: bool = False):
        super().__init__()
        kw = dict(weight_norm=weight_norm, causal=causal)
        self.block = nn.Sequential(
            nn.ELU(), SConv1d(dim, dim // 2, 3, **kw),
            nn.ELU(), SConv1d(dim // 2, dim, 1, **kw))
        self.shortcut = SConv1d(dim, dim, 1, **kw)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


class SEANetEncoder(nn.Module):
    """EnCodec-style strided encoder as HCodec-1.0 configures it (one input
    channel, k7 conv_in, one resnet block per ratio, a 2-layer 8-head
    hybrid transformer, reflect padding; ``causal`` pads every conv on the
    left and masks the transformer causally): conv_in, then per
    ratio (applied reversed) a resnet block, ELU and a strided SConv that
    doubles the width; the transformer; ELU and a stride-2 SConv. Hop
    prod(ratios) * 2 (640 for (8, 5, 4, 2)). (B, L, 1) -> (B, L / hop,
    dimension).

    The layers sit at the reference's ``model.{i}`` indices; the
    reference's layout transposes around the transformer (13, 15) have no
    work to do channels-last and are ``Identity``. ``weight_norm`` trains
    every SConv as (g, v), as the JAX package's encoder does."""

    def __init__(self, dimension: int = 512, n_filters: int = 32,
                 ratios: Tuple[int, ...] = (8, 5, 4, 2),
                 weight_norm: bool = False, causal: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm, causal=causal)
        width = n_filters
        layers = [SConv1d(1, width, 7, **wn)]
        for ratio in reversed(ratios):
            layers += [SEANetResnetBlock(width, **wn), nn.ELU(),
                       SConv1d(width, width * 2, ratio * 2, stride=ratio,
                               **wn)]
            width *= 2
        layers += [nn.Identity(),
                   Transformer(dimension, dimension * 4, 8, 2, causal=causal),
                   nn.Identity(), nn.ELU(),
                   SConv1d(width, dimension, 4, stride=2, **wn)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)
