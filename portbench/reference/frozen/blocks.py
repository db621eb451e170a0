# Frozen copy of unified_audio_tpu_torch/nn/blocks.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""Codec blocks on channels-last (B, T, C) tensors.

Port of ``unified_audio_tpu/nn/blocks.py``: ``AdaLayerNorm``,
``ConvNeXtBlock`` and ``ConvNeXtStack``, ``VocosBackbone``,
``SamplingBlock``, ``Snake1d``, ``DACResidualUnit``, ``WaveDecoderBlock``,
``WaveGenerator``, ``swish``, ``ResnetBlock``, ``AttnBlock``,
``SEANetResnetBlock``, ``SEANetEncoder`` and ``SEANetDecoder``,
``ResBlock1`` and ``VocosResNetBackbone``, each non-causal or causal where
the JAX package has the choice (the HCodec convs' causal zero or reflect
pads, the transformer's causal mask). Submodule names follow the reference
torch layouts (``convnext.{i}.dwconv``, ``model.{i}.block.{j}``, Snake
``alpha`` (1, C, 1), ``post_net.{i}.pwconv1.linear``,
``de_conv_upsampler.1``), the layouts ``export_bicodec_state_dict`` and
``export_hcodec10_state_dict`` write; ``AttnBlock``, ``ResBlock1`` and
``VocosResNetBackbone``, which no export writes, keep the JAX package's
names with ``_{i}`` as ``.{i}``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .conv import (CausalConv1d, Conv1d, ConvTranspose1d, SConv1d,
                   SConvTranspose1d, Wrapped)
from .recurrent import SLSTM
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
    """Learned resampler: (B, T, dim) -> (B, T * up / down, dim). Up: a
    LeakyReLU(0.2) and a transposed conv (kernel 2 * up, stride up, grouped
    by ``groups``) added to the input repeated ``up`` times. Down: a
    LeakyReLU(0.2) and a strided conv (kernel 2 * down) plus the average
    pools (window and stride ``down``) of the upsampled sum and of the
    repeated input. At ratio 1 a side passes its input, so a ratio-1
    block is 3 * x. Convs at ``de_conv_upsampler.1`` and
    ``conv_downsampler.1``."""

    def __init__(self, dim: int, groups: int = 1,
                 upsample_scale: int = 1, downsample_scale: int = 1):
        super().__init__()
        self.up, self.down = upsample_scale, downsample_scale
        up, down = self.up, self.down
        if up > 1:
            self.de_conv_upsampler = nn.Sequential(
                nn.LeakyReLU(0.2),
                ConvTranspose1d(dim, dim, up * 2, up, padding=up // 2 + up % 2,
                                output_padding=up % 2, groups=groups))
        if down > 1:
            self.conv_downsampler = nn.Sequential(
                nn.LeakyReLU(0.2),
                Conv1d(dim, dim, 2 * down, stride=down,
                       padding=down // 2 + down % 2, groups=groups))

    def _pool(self, x):
        return F.avg_pool1d(x.transpose(1, 2), self.down).transpose(1, 2)

    def forward(self, x):
        repeat = merged = x
        if self.up > 1:
            repeat = x.repeat_interleave(self.up, dim=1)
            merged = repeat + self.de_conv_upsampler(x)
        if self.down == 1:
            return merged + repeat + merged
        return (self.conv_downsampler(merged) + self._pool(repeat)
                + self._pool(merged))


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


class AttnBlock(nn.Module):
    """Single-head attention over time with 1x1 convs: GroupNorm(32, eps
    1e-6), q/k/v, softmax (fp32) of q k^T / sqrt(C), ``proj_out``,
    residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (
            CausalConv1d(channels, channels, 1) for _ in range(4))

    def forward(self, x):
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        w = torch.einsum("btc,bsc->bts", q, k) * x.shape[-1] ** -0.5
        w = torch.softmax(w.float(), dim=-1).to(x.dtype)
        return x + self.proj_out(torch.einsum("bts,bsc->btc", w, v))


class SEANetResnetBlock(nn.Module):
    """ELU -> SConv k (dim -> dim / compress, ``dilation``) -> ELU -> SConv
    k1 (back to dim), plus a 1x1 SConv shortcut, or the input itself with
    ``true_skip``. Convs at ``block.1``, ``block.3`` and ``shortcut``."""

    def __init__(self, dim: int, weight_norm: bool = False,
                 causal: bool = False, kernel_size: int = 3,
                 dilation: int = 1, compress: int = 2,
                 true_skip: bool = False):
        super().__init__()
        kw = dict(weight_norm=weight_norm, causal=causal)
        hidden = dim // compress
        self.block = nn.Sequential(
            nn.ELU(), SConv1d(dim, hidden, kernel_size, dilation=dilation,
                              **kw),
            nn.ELU(), SConv1d(hidden, dim, 1, **kw))
        self.shortcut = nn.Identity() if true_skip else SConv1d(dim, dim, 1,
                                                                **kw)

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


class SEANetDecoder(nn.Module):
    """The EnCodec SEANet decoder, the mirror of the encoder: SConv k
    (dimension -> n_filters * 2^len(ratios)), an ``lstm``-layer SLSTM,
    then per ratio ELU, an ``SConvTranspose1d`` (kernel 2 * ratio, stride
    ratio) halving the width and ``n_residual_layers`` resnet blocks
    (dilations ``dilation_base**j``), then ELU and SConv
    ``last_kernel_size`` to ``channels``. (B, T, dimension) -> (B, T *
    prod(ratios), channels). Reflect padding; ``causal`` pads on the left
    and trims the transposed convs by ``trim_right_ratio``. The layers
    sit at the reference's ``model.{i}``."""

    def __init__(self, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, n_residual_layers: int = 1,
                 ratios: Tuple[int, ...] = (8, 5, 4, 2),
                 kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2,
                 causal: bool = False, true_skip: bool = False,
                 compress: int = 2, lstm: int = 2,
                 trim_right_ratio: float = 1.0, weight_norm: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm, causal=causal)
        width = n_filters * 2 ** len(ratios)
        layers = [SConv1d(dimension, width, kernel_size, **wn)]
        if lstm:
            layers.append(SLSTM(width, num_layers=lstm))
        for ratio in ratios:
            layers += [nn.ELU(), SConvTranspose1d(
                width, width // 2, ratio * 2, ratio, causal=causal,
                trim_right_ratio=trim_right_ratio, weight_norm=weight_norm)]
            width //= 2
            layers += [SEANetResnetBlock(
                width, kernel_size=residual_kernel_size,
                dilation=dilation_base ** j, compress=compress,
                true_skip=true_skip, **wn) for j in range(n_residual_layers)]
        layers += [nn.ELU(), SConv1d(width, channels, last_kernel_size, **wn)]
        self.model = nn.Sequential(*layers)

    def forward(self, z):
        return self.model(z)


# ---------------------------------------------------------------------------
# HiFiGAN ResBlock1, the Vocos ResNet backbone
# ---------------------------------------------------------------------------

class ResBlock1(nn.Module):
    """HiFiGAN-V1's dilated residual block without upsampling: per dilation
    d, x += gamma * conv2(lrelu(conv1_d(lrelu(x)))), "same" padding, gamma
    per channel when ``layer_scale_init_value`` is given. Convs at
    ``conv1.{i}`` and ``conv2.{i}``, scales at ``gamma.{i}``."""

    def __init__(self, dim: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5),
                 lrelu_slope: float = 0.1,
                 layer_scale_init_value: Optional[float] = None):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.conv1 = nn.ModuleList([Conv1d(dim, dim, kernel_size, dilation=d)
                                    for d in dilations])
        self.conv2 = nn.ModuleList([Conv1d(dim, dim, kernel_size)
                                    for _ in dilations])
        self.gamma = None if layer_scale_init_value is None else \
            nn.ParameterList([nn.Parameter(torch.full(
                (dim,), float(layer_scale_init_value))) for _ in dilations])

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.conv1, self.conv2)):
            h = c1(F.leaky_relu(x, self.lrelu_slope))
            h = c2(F.leaky_relu(h, self.lrelu_slope))
            x = x + (h if self.gamma is None else self.gamma[i] * h)
        return x


class VocosResNetBackbone(nn.Module):
    """Conv k3 ``embed`` (in_dim -> dim), then ``num_blocks`` ResBlock1s
    (``resnet.{i}``) with layer scale 1 / (3 * num_blocks) unless given."""

    def __init__(self, in_dim: int, dim: int, num_blocks: int,
                 layer_scale_init_value: Optional[float] = None):
        super().__init__()
        self.embed = Conv1d(in_dim, dim, 3)
        scale = layer_scale_init_value or 1.0 / num_blocks / 3
        self.resnet = nn.ModuleList([
            ResBlock1(dim, layer_scale_init_value=scale)
            for _ in range(num_blocks)])

    def forward(self, x):
        x = self.embed(x)
        for block in self.resnet:
            x = block(x)
        return x
