"""1-D convolution primitives on channels-last (B, T, C) tensors.

Port of the parts of ``unified_audio_tpu/nn/conv.py`` that the serving path
uses: ``conv1d``, ``Conv1d`` (torch-style symmetric padding, dilation,
groups) and ``ConvTranspose1d`` (torch padding/output_padding trim), with the
padding arithmetic unchanged. Public functions keep the JAX package's
channels-last layout; weights use torch's layouts (Conv1d (out, in/groups,
K), ConvTranspose1d (in, out, K)). Weight norm is folded into
``weight`` when the weights are loaded, as the reference does for inference.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def conv1d(x, weight, bias=None, stride: int = 1, dilation: int = 1,
           groups: int = 1, padding=(0, 0)):
    """(B, T, Cin) x weight (Cout, Cin/groups, K) -> (B, T', Cout); padding
    is an explicit (left, right) pair of zeros."""
    y = x.transpose(1, 2)
    if padding[0] or padding[1]:
        y = F.pad(y, (padding[0], padding[1]))
    y = F.conv1d(y, weight, bias, stride=stride, dilation=dilation,
                 groups=groups)
    return y.transpose(1, 2)


class Conv1d(nn.Module):
    """Conv with torch-style symmetric ``padding`` (None -> (K-1)//2 *
    dilation), channels-last in and out."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, padding: Optional[int] = None):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = ((kernel_size - 1) // 2 * dilation if padding is None
                        else padding)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.stride, self.dilation,
                      self.groups, (self.padding, self.padding))


class ConvTranspose1d(nn.Module):
    """torch-style ConvTranspose1d, channels-last. ``padding`` None ->
    (stride+1)//2; ``output_padding`` None -> stride % 2. The output is the
    full transposed conv ((T-1)*stride + K) trimmed by ``padding`` on the
    left and ``padding - output_padding`` on the right."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: Optional[int] = None,
                 output_padding: Optional[int] = None, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = (stride + 1) // 2 if padding is None else padding
        self.output_padding = (stride % 2 if output_padding is None
                               else output_padding)
        if self.padding < self.output_padding:
            raise ValueError(f"padding {self.padding} < output_padding "
                             f"{self.output_padding}")
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                               stride=self.stride)
        end = y.shape[-1] - (self.padding - self.output_padding)
        return y[..., self.padding:end].transpose(1, 2)
