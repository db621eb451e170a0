# Frozen copy of unified_audio_tpu_torch/models/bicodec/speaker.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""Speaker (global-token) branch of BiCodec: the ECAPA-TDNN x-vector
network, the Perceiver resampler, the Residual-FSQ tokenizer and the
d-vector projection.

Port of ``unified_audio_tpu/models/bicodec/speaker.py``: ``ConvReluBn``,
``Res2ConvReluBn``, ``SEConnect``, ``SERes2Block``, ``ASTP``, ``ECAPATDNN``,
``PerceiverRMSNorm``, ``PerceiverAttention``, ``GEGLUFeedForward`` (here
``geglu_feed_forward``), ``PerceiverResampler``, ``SpeakerEncoder``
(``tokenize`` and ``detokenize``) and the reference's other pooling heads
``tap_pool``, ``tsdp_pool`` and ``tstp_pool``. Channels-last (B, T, C)
throughout. The branch is frozen: its BatchNorms normalize with their running
statistics (eps 1e-5) whenever the module is in ``.eval()``, which is how the
tokenizer keeps it. The decode-only ``SpeakerEncoder`` (``tokenize=False``,
what serving builds) holds just the FSQ decode and the projection. Submodule
names follow the reference layout
(``speaker_encoder.layer2.se_res2block.1.convs.0``,
``perceiver_sampler.layers.0.1.2``, ...), the layout
``export_bicodec_state_dict`` writes.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .conv import Conv1d
from .quant import ResidualFSQ


class BatchNorm(nn.BatchNorm1d):
    """``torch.nn.BatchNorm1d`` over channels-last (B, T, C) or (B, C)
    input, eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5)

    def forward(self, x):
        if x.dim() == 2:
            return super().forward(x)
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class ConvReluBn(nn.Module):
    """conv -> ReLU -> BatchNorm."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 dilation: int = 1, padding: int = 0):
        super().__init__()
        self.conv = Conv1d(cin, cout, kernel_size, dilation=dilation,
                           padding=padding)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class Res2ConvReluBn(nn.Module):
    """Res2Net block: the channels split into ``scale`` groups; each of the
    first scale - 1 is convolved after the previous group's output is added
    to it; the last passes through."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1, padding: int = 0, scale: int = 8):
        super().__init__()
        self.scale = scale
        width = channels // scale
        nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList([
            Conv1d(width, width, kernel_size, dilation=dilation,
                   padding=padding) for _ in range(nums)])
        self.bns = nn.ModuleList([BatchNorm(width) for _ in range(nums)])

    def forward(self, x):
        parts = torch.chunk(x, self.scale, dim=-1)
        out = []
        sp = parts[0]
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            if i >= 1:
                sp = sp + parts[i]
            sp = bn(F.relu(conv(sp)))
            out.append(sp)
        if self.scale != 1:
            out.append(parts[-1])
        return torch.cat(out, dim=-1)


class SEConnect(nn.Module):
    """Squeeze-excitation over time."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.linear1 = nn.Linear(channels, bottleneck)
        self.linear2 = nn.Linear(bottleneck, channels)

    def forward(self, x):
        s = F.relu(self.linear1(x.mean(dim=-2)))
        return x * torch.sigmoid(self.linear2(s))[:, None, :]


class SERes2Block(nn.Module):
    """1x1 ConvReluBn, Res2 block, 1x1 ConvReluBn, SE; residual. The four
    sit at ``se_res2block.{0..3}``."""

    def __init__(self, channels: int, kernel_size: int, dilation: int,
                 padding: int, scale: int = 8):
        super().__init__()
        self.se_res2block = nn.Sequential(
            ConvReluBn(channels, channels),
            Res2ConvReluBn(channels, kernel_size, dilation, padding, scale),
            ConvReluBn(channels, channels),
            SEConnect(channels))

    def forward(self, x):
        return x + self.se_res2block(x)


class ASTP(nn.Module):
    """Attentive statistics pooling with global context: (B, T, C) ->
    (B, 2C). Its two projections are 1x1 convs in the reference, stored
    as (out, in, 1)."""

    def __init__(self, in_dim: int, bottleneck: int = 128):
        super().__init__()
        self.linear1 = Conv1d(in_dim * 3, bottleneck, 1, padding=0)
        self.linear2 = Conv1d(bottleneck, in_dim, 1, padding=0)

    def forward(self, x):
        mean = x.mean(dim=-2, keepdim=True)
        std = torch.sqrt(x.var(dim=-2, keepdim=True, correction=0) + 1e-7)
        x_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(x_in))),
                              dim=-2)
        mean = (alpha * x).sum(dim=-2)
        var = (alpha * x * x).sum(dim=-2) - mean ** 2
        return torch.cat([mean, torch.sqrt(var.clamp(min=1e-7))], dim=-1)


class ECAPATDNN(nn.Module):
    """x-vector network (the GLOB_c512 variant): feats (B, T, F) ->
    (embedding (B, E), latent (B, T, 1536))."""

    def __init__(self, feat_dim: int = 128, channels: int = 512,
                 embed_dim: int = 512):
        super().__init__()
        c = channels
        self.layer1 = ConvReluBn(feat_dim, c, 5, padding=2)
        self.layer2 = SERes2Block(c, 3, 2, 2)
        self.layer3 = SERes2Block(c, 3, 3, 3)
        self.layer4 = SERes2Block(c, 3, 4, 4)
        self.conv = Conv1d(c * 3, 512 * 3, 1, padding=0)
        self.pool = ASTP(512 * 3)
        self.bn = BatchNorm(512 * 3 * 2)
        self.linear = nn.Linear(512 * 3 * 2, embed_dim)

    def forward(self, x):
        out2 = self.layer2(self.layer1(x))
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        latent = F.relu(self.conv(torch.cat([out2, out3, out4], dim=-1)))
        return self.linear(self.bn(self.pool(latent))), latent


class PerceiverRMSNorm(nn.Module):
    """x / max(|x|, 1e-12) * sqrt(dim) * gamma."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.normalize(x, dim=-1, eps=1e-12) * self.scale * self.gamma


class PerceiverAttention(nn.Module):
    """Cross-attention of the latents over [latents ‖ context], no
    biases."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, latents, context):
        h, hd = self.heads, self.dim_head
        b, tq, _ = latents.shape
        q = self.to_q(latents).view(b, tq, h, hd)
        k, v = self.to_kv(torch.cat([latents, context], dim=-2)).chunk(2, -1)
        k = k.reshape(b, -1, h, hd)
        v = v.reshape(b, -1, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, tq, h * hd)
        return self.to_out(out)


class GEGLU(nn.Module):
    def forward(self, x):
        a, gate = x.chunk(2, dim=-1)
        return F.gelu(gate) * a


def geglu_feed_forward(dim: int, mult: int = 4) -> nn.Sequential:
    """Linear -> GEGLU -> Linear, inner width dim * mult * 2 / 3 (the
    linears at ``0`` and ``2``)."""
    inner = int(dim * mult * 2 / 3)
    return nn.Sequential(nn.Linear(dim, inner * 2), GEGLU(),
                         nn.Linear(inner, dim))


class PerceiverResampler(nn.Module):
    """``num_latents`` learned latents cross-attend to the context
    sequence: (B, T, dim_context) -> (B, num_latents, dim); the context
    passes ``proj_context``, the identity when ``dim_context == dim``."""

    def __init__(self, dim: int, dim_context: int, num_latents: int = 32,
                 depth: int = 2, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4):
        super().__init__()
        self.proj_context = (nn.Identity() if dim_context == dim
                             else nn.Linear(dim_context, dim))
        self.latents = nn.Parameter(torch.zeros(num_latents, dim))
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads),
                           geglu_feed_forward(dim, ff_mult)])
            for _ in range(depth)])
        self.norm = PerceiverRMSNorm(dim)

    def forward(self, x):
        x = self.proj_context(x)
        latents = self.latents[None].expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            latents = attn(latents, x) + latents
            latents = ff(latents) + latents
        return self.norm(latents)


class SpeakerEncoder(nn.Module):
    """Global speaker tokens: ``tokenize`` (mels (B, T, F) -> indices
    (B, token_num, nq), built with ``tokenize=True``) and ``detokenize``
    (indices -> d-vector (B, out_dim))."""

    def __init__(self, input_dim: int = 128, out_dim: int = 1024,
                 latent_dim: int = 128, token_num: int = 32,
                 fsq_levels: Sequence[int] = (4, 4, 4, 4, 4, 4),
                 fsq_num_quantizers: int = 1, tokenize: bool = False):
        super().__init__()
        if tokenize:
            self.speaker_encoder = ECAPATDNN(input_dim, 512, out_dim)
            self.perceiver_sampler = PerceiverResampler(
                latent_dim, 512 * 3, num_latents=token_num)
        self.quantizer = ResidualFSQ(fsq_levels, fsq_num_quantizers,
                                     latent_dim, tokenize=tokenize)
        self.project = nn.Linear(latent_dim * token_num, out_dim)

    @staticmethod
    def _flatten_cf(zq):
        """(B, T, D) -> (B, D*T), flattened channel-major like the
        reference's channel-first tensor (the project weights are laid out
        d-major)."""
        return zq.transpose(1, 2).reshape(zq.shape[0], -1)

    def tokenize(self, mels):
        """mels (B, T, input_dim) -> global tokens (B, token_num, nq)."""
        _, latent = self.speaker_encoder(mels)
        return self.quantizer(self.perceiver_sampler(latent))

    def detokenize(self, indices):
        """Global tokens (B, token_num, nq) -> d-vector (B, out_dim)."""
        zq = self.quantizer.get_output_from_indices(indices)
        return self.project(self._flatten_cf(zq))


# ---------------------------------------------------------------------------
# The reference's other pooling heads (TAP, TSDP, TSTP; ASTP above)
# ---------------------------------------------------------------------------

def tap_pool(x):
    """Temporal average pooling, (B, T, C) -> (B, C)."""
    return x.mean(dim=-2)


def tsdp_pool(x):
    """Temporal standard-deviation pooling (population variance, + 1e-7
    under the root), (B, T, C) -> (B, C)."""
    return torch.sqrt(x.var(dim=-2, correction=0) + 1e-7)


def tstp_pool(x):
    """Temporal statistics pooling, [mean, std], (B, T, C) -> (B, 2C)."""
    return torch.cat([tap_pool(x), tsdp_pool(x)], dim=-1)
