# Frozen copy of unified_audio_tpu_torch/nn/conv.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""1-D convolution primitives on channels-last (B, T, C) tensors.

Port of ``unified_audio_tpu/nn/conv.py``: ``conv1d``, ``conv_transpose1d``,
``Conv1d`` (torch-style symmetric padding, dilation, groups),
``ConvTranspose1d`` (torch padding/output_padding trim) and, for HCodec,
the EnCodec padding math (``get_extra_padding_for_conv1d``, ``pad1d``,
``unpad1d``), ``SConv1d``,
``SConvTranspose1d``, ``CausalConv1d`` and ``SubPixelConvTranspose1d``, each
non-causal or causal, with the padding arithmetic unchanged.
Public functions keep the JAX package's channels-last layout; weights use
torch's layouts (Conv1d (out, in/groups, K), ConvTranspose1d (in, out, K)).
At inference weight norm is folded into ``weight`` when the weights are
loaded (``utils/convert.py``), as the reference does. For training,
``Conv1d(weight_norm=True)`` (and ``SConv1d``, which passes it on) keeps
the parametrization trainable as ``weight_g`` (out, 1, 1) and ``weight_v``
(out, in/groups, K), the reference's names, and builds its kernel each call
(:func:`weight_norm_kernel`); ``ConvTranspose1d(weight_norm=True)`` keeps
``weight_g`` (1, out, 1) and ``weight_v`` (in, out, K), the norm again per
output channel, as the JAX package takes it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def weight_norm_kernel(g, v):
    """``g * v / sqrt(sum(v^2) + 1e-12)``, the sum over (in, K) per output
    channel: the JAX package's weight norm, its epsilon inside the root
    (``torch.nn.utils.weight_norm`` has none)."""
    return v * (g / torch.sqrt(v.square().sum(dim=(1, 2), keepdim=True)
                               + 1e-12))


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


def conv_transpose1d(x, weight, stride: int):
    """Full (padding 0) transposed conv: (B, T, Cin) x weight (Cin, Cout,
    K) -> (B, (T - 1) * stride + K, Cout)."""
    return F.conv_transpose1d(x.transpose(1, 2), weight,
                              stride=stride).transpose(1, 2)


class Conv1d(nn.Module):
    """Conv with torch-style symmetric ``padding`` (None -> (K-1)//2 *
    dilation), channels-last in and out. ``weight_norm`` trains the kernel
    as ``weight_g`` and ``weight_v`` (``kernel`` builds it)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, padding: Optional[int] = None,
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = ((kernel_size - 1) // 2 * dilation if padding is None
                        else padding)
        self.weight_norm = weight_norm
        shape = (out_channels, in_channels // groups, kernel_size)
        if weight_norm:
            self.weight_g = nn.Parameter(torch.ones(out_channels, 1, 1))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def kernel(self):
        """The (out, in/groups, K) kernel of this call."""
        if self.weight_norm:
            return weight_norm_kernel(self.weight_g, self.weight_v)
        return self.weight

    def forward(self, x):
        return conv1d(x, self.kernel(), self.bias, self.stride,
                      self.dilation, self.groups, (self.padding, self.padding))


class ConvTranspose1d(nn.Module):
    """torch-style ConvTranspose1d, channels-last. ``padding`` None ->
    (stride+1)//2; ``output_padding`` None -> stride % 2. The output is the
    full transposed conv ((T-1)*stride + K) trimmed by ``padding`` on the
    left and ``padding - output_padding`` on the right. ``groups`` as in
    torch (weight (in, out / groups, K))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: Optional[int] = None,
                 output_padding: Optional[int] = None, bias: bool = True,
                 weight_norm: bool = False, groups: int = 1):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.padding = (stride + 1) // 2 if padding is None else padding
        self.output_padding = (stride % 2 if output_padding is None
                               else output_padding)
        if self.padding < self.output_padding:
            raise ValueError(f"padding {self.padding} < output_padding "
                             f"{self.output_padding}")
        self.weight_norm = weight_norm
        shape = (in_channels, out_channels // groups, kernel_size)
        if weight_norm:
            if groups != 1:
                raise ValueError("weight norm on a grouped transposed conv")
            self.weight_g = nn.Parameter(torch.ones(1, out_channels, 1))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def kernel(self):
        """The (in, out, K) kernel of this call; weight norm takes the norm
        over (in, K) of each output channel."""
        if self.weight_norm:
            v = self.weight_v
            return v * (self.weight_g / torch.sqrt(
                v.square().sum(dim=(0, 2), keepdim=True) + 1e-12))
        return self.weight

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.kernel(), self.bias,
                               stride=self.stride, groups=self.groups)
        end = y.shape[-1] - (self.padding - self.output_padding)
        return y[..., self.padding:end].transpose(1, 2)


class Wrapped(nn.Module):
    """``module`` one name level down, at ``<this>.<attr>``: the reference
    layouts wrap convs and linears (``dwconv.conv.weight``,
    ``pwconv1.linear.weight``)."""

    def __init__(self, attr: str, module: nn.Module):
        super().__init__()
        self.attr = attr
        setattr(self, attr, module)

    def forward(self, x):
        return getattr(self, self.attr)(x)


# ---------------------------------------------------------------------------
# EnCodec padding math
# ---------------------------------------------------------------------------

def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int = 0) -> int:
    """Extra right padding so that the last conv window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (
        kernel_size - padding_total)
    return ideal_length - length


def pad1d(x, paddings: Tuple[int, int]):
    """Reflect-pad the time axis of (B, T, C) (the mode of the EnCodec
    convs). An input no longer than the pad is zero-extended first and
    that is trimmed afterwards (``F.pad`` refuses such an input)."""
    left, right = paddings
    if left < 0 or right < 0:
        raise ValueError(f"negative padding {paddings}")
    y = x.transpose(1, 2)
    extra = max(max(left, right) - y.shape[-1] + 1, 0)
    if extra:
        y = F.pad(y, (0, extra))
    y = F.pad(y, (left, right), mode="reflect")
    if extra:
        y = y[..., :y.shape[-1] - extra]
    return y.transpose(1, 2)


def unpad1d(x, paddings: Tuple[int, int]):
    """Trim ``paddings`` (left, right) from the time axis of (B, T, C)."""
    left, right = paddings
    return x[..., left:x.shape[-2] - right, :]


class SConv1d(nn.Module):
    """EnCodec conv: the reflect pad of span - stride (span = (K - 1) *
    dilation + 1), all of it on the left when ``causal``, else split with
    the larger half on the left, plus the extra right pad for a full last
    window. Weight at ``conv.conv`` (``weight_g``/``weight_v`` with
    ``weight_norm``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, weight_norm: bool = False,
                 causal: bool = False, dilation: int = 1):
        super().__init__()
        self.span = (kernel_size - 1) * dilation + 1
        self.stride, self.causal = stride, causal
        self.conv = Wrapped("conv", Conv1d(in_channels, out_channels,
                                           kernel_size, stride=stride,
                                           dilation=dilation, padding=0,
                                           weight_norm=weight_norm))

    def forward(self, x):
        total = self.span - self.stride
        extra = get_extra_padding_for_conv1d(x.shape[1], self.span,
                                             self.stride, total)
        if self.causal:
            return self.conv(pad1d(x, (total, extra)))
        right = total // 2
        return self.conv(pad1d(x, (total - right, right + extra)))


class SConvTranspose1d(nn.Module):
    """EnCodec transposed conv: the full transposed conv, then K - stride
    trimmed: ``ceil((K - stride) * trim_right_ratio)`` on the right and
    the rest on the left when ``causal``, else split with the larger half
    on the left. Weight at ``convtr.convtr``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False,
                 trim_right_ratio: float = 1.0, weight_norm: bool = False):
        super().__init__()
        total = kernel_size - stride
        right = (math.ceil(total * trim_right_ratio) if causal
                 else total // 2)
        self.trim = (total - right, right)
        self.convtr = Wrapped("convtr", ConvTranspose1d(
            in_channels, out_channels, kernel_size, stride, padding=0,
            output_padding=0, weight_norm=weight_norm))

    def forward(self, x):
        y = self.convtr(x)
        return y[:, self.trim[0]:y.shape[1] - self.trim[1]]


class CausalConv1d(nn.Module):
    """HCodec constant-pad conv: odd kernel, dilated span dk = (K - 1) *
    dilation + 1; zeros (dk - stride, 0) when causal, else (dk // 2,
    dk // 2); ``groups`` as in ``Conv1d``. Weight at ``conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 causal: bool = False, stride: int = 1, dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        self.stride, self.dilation, self.groups = stride, dilation, groups
        dk = (kernel_size - 1) * dilation + 1
        self.pads = (dk - stride, 0) if causal else (dk // 2, dk // 2)
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           groups=groups, padding=0)

    def forward(self, x):
        return conv1d(x, self.conv.weight, self.conv.bias, self.stride,
                      self.dilation, self.groups, padding=self.pads)


class SubPixelConvTranspose1d(nn.Module):
    """HCodec upsampler: 1x1 conv to stride * C channels, channels to time
    ((B, T, stride * C) -> (B, T * stride, C), the stride index major in
    the channel axis), zero pad (K - 1, 0) when causal, else (K // 2,
    K // 2), depthwise conv. Weights at ``up`` and ``dw``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        self.stride, self.channels = stride, out_channels
        self.pads = ((kernel_size - 1, 0) if causal
                     else (kernel_size // 2, kernel_size // 2))
        self.up = Conv1d(in_channels, out_channels * stride, 1, padding=0)
        self.dw = Conv1d(out_channels, out_channels, kernel_size,
                         groups=out_channels, padding=0)

    def forward(self, x):
        b, t, _ = x.shape
        y = self.up(x).reshape(b, t * self.stride, self.channels)
        return conv1d(y, self.dw.weight, self.dw.bias, groups=self.channels,
                      padding=self.pads)
