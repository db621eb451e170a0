"""The wav2vec2-family SSL encoders: WavLM-base-plus, HuBERT-base and
wav2vec2-large-XLSR-53.

Port of ``unified_audio_tpu/models/ssl/wav2vec2.py``: ``SSLConfig``, the
7-layer conv feature extractor (GroupNorm on layer 0, or a LayerNorm over
channels after every conv for XLSR-53; exact GELU), the grouped positional
conv (the trailing element dropped for an even kernel), the T5-style
relative-position buckets and the gated relative-position bias (WavLM
only), the post-LN encoder layers of the base models and the pre-LN
("stable layer norm") layers of XLSR-53 with their final encoder
LayerNorm, ``Wav2Vec2Model``, ``wavlm_features`` (UniSE),
``hubert_features`` (HCodec) and ``xlsr_features`` (BiCodec's semantic
input). Parameter names follow the HF layout
(``feature_extractor.conv_layers.{i}.conv.weight``,
``encoder.layers.{i}.attention.q_proj.weight``, ...), with the positional
conv's weight norm folded into ``encoder.pos_conv_embed.conv.weight``.
Hidden states are (B, T, C).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


@dataclass(frozen=True)
class SSLConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" | "layer"
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    # WavLM relative position bias
    use_rel_pos_bias: bool = False
    num_buckets: int = 320
    max_distance: int = 800


def hubert_base_config() -> SSLConfig:
    """HuBERT-base: the group-norm, post-LN base config, no relative
    position bias."""
    return SSLConfig()


def wavlm_base_plus_config() -> SSLConfig:
    return SSLConfig(use_rel_pos_bias=True)


def wav2vec2_large_xlsr53_config() -> SSLConfig:
    """XLSR-53: 24 pre-LN layers of 1024, a LayerNorm after every conv of
    the extractor, conv biases."""
    return SSLConfig(
        hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
        conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True,
    )


def conv_frames(cfg: SSLConfig, n_samples: int) -> int:
    """Frames the conv feature extractor makes from ``n_samples``."""
    n = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


class _ConvLayer(nn.Module):
    """conv -> norm -> GELU on (B, C, T); ``norm`` is "group" (GroupNorm
    with a group per channel), "layer" (LayerNorm over channels) or None."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, bias: bool,
                 norm):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=stride, bias=bias)
        self.layer_norm = {"group": nn.GroupNorm(cout, cout, eps=1e-5),
                           "layer": nn.LayerNorm(cout, eps=1e-5),
                           None: None}[norm]

    def forward(self, x):  # (B, C, T)
        x = self.conv(x)
        if isinstance(self.layer_norm, nn.LayerNorm):
            x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        elif self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class FeatureExtractor(nn.Module):
    """7-layer strided conv frontend, 320x downsample: (B, N) -> (B, T, C)."""

    def __init__(self, cfg: SSLConfig):
        super().__init__()
        if cfg.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm {cfg.feat_extract_norm!r}")
        cin, layers = 1, []
        for i, (dim, k, s) in enumerate(
                zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            norm = cfg.feat_extract_norm
            if norm == "group" and i > 0:
                norm = None
            layers.append(_ConvLayer(cin, dim, k, s, cfg.conv_bias, norm))
            cin = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav):
        h = wav[:, None]
        for layer in self.conv_layers:
            h = layer(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: SSLConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=1e-5)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv, same-padded; an even kernel drops the last frame."""

    def __init__(self, cfg: SSLConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)

    def forward(self, x):
        x = x.transpose(1, 2)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            # oneDNN's bf16 grouped conv1d is wrong on the CPU at some
            # shapes (16 taps in 4 groups: ~100% relative error, torch
            # 2.13); the native kernel is right
            with torch.backends.mkldnn.flags(enabled=False):
                h = self.conv(x).transpose(1, 2)
        else:
            h = self.conv(x).transpose(1, 2)
        if self.conv.kernel_size[0] % 2 == 0:
            h = h[:, :-1]
        return F.gelu(h)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """WavLM T5-style bidirectional relative position buckets (numpy)."""
    relative = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    nb = num_buckets // 2
    buckets = (relative > 0).astype(np.int64) * nb
    rel = np.abs(relative)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


class SSLSelfAttention(nn.Module):
    def __init__(self, cfg: SSLConfig, has_relative_position_bias: bool):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        self.cfg = cfg
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        if cfg.use_rel_pos_bias:
            self.gru_rel_pos_linear = nn.Linear(d // h, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
            if has_relative_position_bias:
                self.rel_attn_embed = nn.Embedding(cfg.num_buckets, h)

    def forward(self, x, position_bias=None):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        hd = d // h
        if cfg.use_rel_pos_bias and position_bias is None:
            buckets = torch.as_tensor(relative_position_buckets(
                t, t, cfg.num_buckets, cfg.max_distance), device=x.device)
            position_bias = self.rel_attn_embed(buckets).permute(2, 0, 1)
        q = self.q_proj(x).view(b, t, h, hd)
        k = self.k_proj(x).view(b, t, h, hd)
        v = self.v_proj(x).view(b, t, h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        if cfg.use_rel_pos_bias:
            # gated relative position bias, gates from the per-head query
            proj = self.gru_rel_pos_linear(q.transpose(1, 2))  # (B, H, T, 8)
            gates = torch.sigmoid(proj.view(b, h, t, 2, 4).sum(-1))
            gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
            gate_out = gate_a * (gate_b * self.gru_rel_pos_const - 1.0) + 2.0
            logits = logits + gate_out * position_bias[None]
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        return self.out_proj(out), position_bias


class FeedForward(nn.Module):
    def __init__(self, cfg: SSLConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class SSLEncoderLayer(nn.Module):
    """Encoder layer: post-LN (base models) or pre-LN (``do_stable_layer_norm``,
    XLSR-53)."""

    def __init__(self, cfg: SSLConfig, has_relative_position_bias: bool):
        super().__init__()
        self.pre_ln = cfg.do_stable_layer_norm
        self.attention = SSLSelfAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, x, position_bias=None):
        if self.pre_ln:
            h, position_bias = self.attention(self.layer_norm(x),
                                              position_bias)
            x = x + h
            return x + self.feed_forward(self.final_layer_norm(x)), \
                position_bias
        h, position_bias = self.attention(x, position_bias)
        x = self.layer_norm(x + h)
        x = self.final_layer_norm(x + self.feed_forward(x))
        return x, position_bias


class Encoder(nn.Module):
    def __init__(self, cfg: SSLConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.layers = nn.ModuleList(
            [SSLEncoderLayer(cfg, i == 0) for i in range(cfg.num_layers)])


class Wav2Vec2Model(nn.Module):
    """Frozen SSL encoder: wav (B, N) -> tuple of num_layers + 1 hidden
    states (B, T, C), embeddings first (the HF layout). The post-LN models
    normalize the embeddings; the pre-LN model applies the encoder
    LayerNorm once, to the last layer's output, which is the last
    element."""

    def __init__(self, cfg: SSLConfig):
        super().__init__()
        self.config = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, wav):
        enc = self.encoder
        stable = self.config.do_stable_layer_norm
        h = self.feature_projection(self.feature_extractor(wav))
        h = h + enc.pos_conv_embed(h)
        if not stable:
            h = enc.layer_norm(h)
        hidden_states = [h]
        position_bias = None
        for layer in enc.layers:
            h, position_bias = layer(h, position_bias)
            hidden_states.append(h)
        if stable:
            hidden_states[-1] = enc.layer_norm(h)
        return tuple(hidden_states)


def wavlm_features(hidden_states) -> torch.Tensor:
    """All-layer mean, no compression (the UniSE conditioning features)."""
    return torch.stack(hidden_states, dim=0).mean(dim=0)


def hubert_features(hidden_states) -> torch.Tensor:
    """All-layer mean, then signed |x|^0.3 (HCodec's SSL features)."""
    mix = torch.stack(hidden_states, dim=0).mean(dim=0)
    sign = torch.where(mix > 0, 1.0, -1.0).to(mix.dtype)
    return sign * mix.abs() ** 0.3


def xlsr_features(hidden_states, layers=(11, 14, 16)) -> torch.Tensor:
    """(h11 + h14 + h16) / 3, BiCodec's semantic input. The indices clamp
    to the available depth, so shallow configs stay valid."""
    n = len(hidden_states)
    picked = [hidden_states[min(i, n - 1)] for i in layers]
    return sum(picked) / float(len(picked))
