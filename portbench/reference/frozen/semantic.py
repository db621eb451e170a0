# Frozen copy of unified_audio_tpu_torch/models/hcodec/semantic.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""Semantic encoder and decoder of HCodec: conv residual stacks mapping SSL
features to the codec's latent rate and back, channels-last.

Port of ``ResidualUnit``, ``EncoderBlock``, ``SemanticEncoder``,
``DecoderBlock`` and ``SemanticDecoder`` in
``unified_audio_tpu/models/hcodec/semantic.py``. Parameter names follow the
reference layout (``conv.conv.weight``, ``conv_blocks.{i}.res_units.{j}``,
``conv2.conv.weight``; the decoder's ``conv1.conv.weight`` and, for a
strided block, ``conv_blocks.{i}.conv.deconv``). The decoder only produces
``pred_feat``, the training target, so only a codec built for training has
one.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn
from torch.nn import functional as F

from .conv import Conv1d, ConvTranspose1d, Wrapped


class ResidualUnit(nn.Module):
    """ELU -> conv k3 dilated -> ELU -> 1x1, residual; no biases."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = Wrapped("conv", Conv1d(channels, channels, kernel_size,
                                            dilation=dilation, bias=False))
        self.conv2 = Conv1d(channels, channels, 1, padding=0, bias=False)

    def forward(self, x):
        return x + self.conv2(F.elu(self.conv1(F.elu(x))))


class EncoderBlock(nn.Module):
    """Residual units, then a strided conv (kernel 2 * stride, or 3 for
    stride 1) to ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 dilations: Sequence[int] = (1, 1), unit_kernel_size: int = 3):
        super().__init__()
        self.res_units = nn.ModuleList([
            ResidualUnit(in_channels, unit_kernel_size, d) for d in dilations])
        k = 3 if stride == 1 else 2 * stride
        self.conv = Wrapped("conv", Conv1d(in_channels, out_channels, k,
                                           stride=stride))

    def forward(self, x):
        for unit in self.res_units:
            x = unit(x)
        return self.conv(x)


class SemanticEncoder(nn.Module):
    """SSL features (B, T, input_channels) -> (B, T / prod(strides),
    out_channels)."""

    def __init__(self, input_channels: int, encode_channels: int,
                 out_channels: int, channel_ratios: Sequence[float] = (1, 1),
                 strides: Sequence[int] = (2, 1), kernel_size: int = 3):
        super().__init__()
        self.conv = Wrapped("conv", Conv1d(input_channels, encode_channels,
                                           kernel_size, bias=False))
        blocks, cin = [], encode_channels
        for ratio, stride in zip(channel_ratios, strides):
            cout = int(encode_channels * ratio)
            blocks.append(EncoderBlock(cin, cout, stride))
            cin = cout
        self.conv_blocks = nn.ModuleList(blocks)
        self.conv2 = Wrapped("conv", Conv1d(cin, out_channels, kernel_size,
                                            bias=False))

    def forward(self, x):
        x = self.conv(x)
        for block in self.conv_blocks:
            x = block(x)
        return self.conv2(x)


class DecoderBlock(nn.Module):
    """A conv k3 (stride 1) or a transposed conv of kernel 2 * stride
    (torch padding), then residual units at ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 dilations: Sequence[int] = (1, 1), unit_kernel_size: int = 3):
        super().__init__()
        if stride == 1:
            self.conv = Wrapped("conv", Conv1d(in_channels, out_channels, 3))
        else:
            self.conv = Wrapped("deconv", ConvTranspose1d(
                in_channels, out_channels, 2 * stride, stride=stride))
        self.res_units = nn.ModuleList([
            ResidualUnit(out_channels, unit_kernel_size, d)
            for d in dilations])

    def forward(self, x):
        x = self.conv(x)
        for unit in self.res_units:
            x = unit(x)
        return x


class SemanticDecoder(nn.Module):
    """Latents (B, T, code_dim) -> SSL features (B, T prod(strides),
    output_channels)."""

    def __init__(self, code_dim: int, output_channels: int,
                 decode_channels: int, channel_ratios: Sequence[float] = (1, 1),
                 strides: Sequence[int] = (2, 1), kernel_size: int = 3):
        super().__init__()
        cin = int(decode_channels * channel_ratios[0])
        self.conv1 = Wrapped("conv", Conv1d(code_dim, cin, kernel_size,
                                            bias=False))
        blocks, n = [], len(strides)
        for i, stride in enumerate(strides):
            cout = (int(decode_channels * channel_ratios[i + 1])
                    if i < n - 1 else decode_channels)
            blocks.append(DecoderBlock(cin, cout, stride))
            cin = cout
        self.conv_blocks = nn.ModuleList(blocks)
        self.conv2 = Wrapped("conv", Conv1d(cin, output_channels,
                                            kernel_size, bias=False))

    def forward(self, z):
        x = self.conv1(z)
        for block in self.conv_blocks:
            x = block(x)
        return self.conv2(x)
