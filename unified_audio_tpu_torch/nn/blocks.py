"""Codec decoder blocks on channels-last (B, T, C) tensors.

Port of the blocks of ``unified_audio_tpu/nn/blocks.py`` that BiCodec's
detokenize path runs: ``AdaLayerNorm``, ``ConvNeXtBlock`` (stacked as
``VocosBackbone.convnext``), ``VocosBackbone``, ``SamplingBlock`` (ratio-1
path), ``Snake1d``, ``DACResidualUnit``, ``WaveDecoderBlock`` and
``WaveGenerator``. Submodule names follow the reference torch layout
(``convnext.{i}.dwconv``, ``model.{i}.block.{j}``, Snake ``alpha`` (1, C,
1)), the layout ``export_bicodec_state_dict`` writes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .conv import Conv1d, ConvTranspose1d


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
    residual."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init_value: float,
                 condition_dim: Optional[int] = None):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, groups=dim, padding=3)
        self.norm = (AdaLayerNorm(condition_dim, dim) if condition_dim
                     else nn.LayerNorm(dim, eps=1e-6))
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x, cond=None):
        h = self.dwconv(x)
        h = self.norm(h, cond) if isinstance(self.norm, AdaLayerNorm) \
            else self.norm(h)
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + self.gamma * h


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
                                      "ported")

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
    """Snake -> conv k7 dilated (same pad) -> Snake -> conv k1, residual."""

    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.ModuleList([
            Snake1d(dim), Conv1d(dim, dim, 7, dilation=dilation, padding=pad),
            Snake1d(dim), Conv1d(dim, dim, 1, padding=0)])

    def forward(self, x):
        y = x
        for m in self.block:
            y = m(y)
        return x + y


class WaveDecoderBlock(nn.Module):
    """Snake -> transposed conv (k, s, pad (k-s)//2) -> 3 dilated residual
    units."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.block = nn.ModuleList([
            Snake1d(input_dim),
            ConvTranspose1d(input_dim, output_dim, kernel_size, stride,
                            padding=(kernel_size - stride) // 2,
                            output_padding=0),
            DACResidualUnit(output_dim, 1), DACResidualUnit(output_dim, 3),
            DACResidualUnit(output_dim, 9)])

    def forward(self, x):
        for m in self.block:
            x = m(x)
        return x


class WaveGenerator(nn.Module):
    """DAC-style vocoder head: (B, T, input_channel) -> (B, T * prod(rates),
    d_out) in [-1, 1]."""

    def __init__(self, input_channel: int, channels: int,
                 rates: Sequence[int], kernel_sizes: Sequence[int],
                 d_out: int = 1):
        super().__init__()
        layers = [Conv1d(input_channel, channels, 7, padding=3)]
        dim = channels
        for i, (k, s) in enumerate(zip(kernel_sizes, rates)):
            out_dim = channels // 2 ** (i + 1)
            layers.append(WaveDecoderBlock(dim, out_dim, k, s))
            dim = out_dim
        layers += [Snake1d(dim), Conv1d(dim, d_out, 7, padding=3)]
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        for m in self.model:
            x = m(x)
        return torch.tanh(x)
