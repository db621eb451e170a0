"""The SenseVoice SAN-M encoder, FlexiCodec's semantic teacher.

Port of ``unified_audio_tpu/models/ssl/sanm.py``: ``SANMConfig``,
``sensevoice_small_config``, ``sinusoidal_pe``, ``SANMAttention``,
``SANMLayer``, ``SANMEncoder`` and ``SenseVoiceSemanticEncoder``.

* Input: kaldi fbank + LFR(7, 6) + CMVN features (``ops/fbank.py``), (B, T,
  560), with 4 query frames prepended from the embedding table: ids
  [language ("auto" = 0), 1, 2, textnorm ("woitn" = 15)].
* Encoder: x * sqrt(512) plus the sinusoidal position table (positions from
  1, [sin | cos] over 280 timescales), ``encoders0`` (560 -> 512, no
  attention residual), 49 more SAN-M layers, ``after_norm`` (the trunk
  output FlexiCodec reads, the 4 query frames stripped), then 20 ``tp``
  layers and ``tp_norm``.
* A SAN-M layer: pre-LN attention whose value stream also runs an FSMN
  memory block (a depthwise conv of kernel 11, zero pads ((K-1)//2 +
  shift, the rest), plus its input, masked) added to the attention output;
  then a pre-LN ReLU feed-forward, residual. LayerNorm eps 1e-6, as in the
  JAX package.

Module names follow funasr's SenseVoiceSmall state dict
(``encoder.encoders0.0.self_attn.linear_q_k_v``, ``self_attn.fsmn_block``
(C, 1, K), ``feed_forward.w_1``, ``encoder.tp_encoders.{i}``,
``embed.weight``), the layout the JAX package's ``convert_sensevoice``
reads; ``utils/convert.py sensevoice_keys`` keeps the keys this module
has.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


@dataclass(frozen=True)
class SANMConfig:
    input_size: int = 560  # 80 mel x LFR m = 7
    output_size: int = 512
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 50  # encoders0 (560 -> 512) + 49
    tp_blocks: int = 20
    kernel_size: int = 11
    sanm_shift: int = 0
    embed_vocab: int = 16  # the query-embedding table
    lang_id: int = 0  # lid_dict["auto"]
    textnorm_id: int = 15  # textnorm_dict["woitn"]


def sensevoice_small_config() -> SANMConfig:
    return SANMConfig()


def sinusoidal_pe(length: int, depth: int, dtype=torch.float32,
                  device=None):
    """funasr's SinusoidalPositionEncoder: positions 1..length, [sin | cos]
    over depth / 2 timescales (computed in fp64, then cast)."""
    positions = np.arange(1, length + 1, dtype=np.float64)
    half = depth // 2
    inv = np.exp(np.arange(half, dtype=np.float64)
                 * -(np.log(10000.0) / (half - 1)))
    scaled = positions[:, None] * inv[None, :]
    pe = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return torch.as_tensor(pe, dtype=dtype, device=device)


class SANMAttention(nn.Module):
    """Softmax attention plus the FSMN memory of the value stream."""

    def __init__(self, in_feat: int, n_feat: int, heads: int,
                 kernel_size: int, sanm_shift: int = 0):
        super().__init__()
        self.heads, self.kernel_size = heads, kernel_size
        self.sanm_shift = sanm_shift
        self.linear_q_k_v = nn.Linear(in_feat, 3 * n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.fsmn_block = nn.Conv1d(n_feat, n_feat, kernel_size,
                                    groups=n_feat, bias=False)

    def forward(self, x, mask=None):
        """x (B, T, in); ``mask`` (B, T) 1/0 key validity, or None."""
        b, t, _ = x.shape
        q, k, v = self.linear_q_k_v(x).chunk(3, dim=-1)
        n = v.shape[-1]
        d_k = n // self.heads
        inp = v if mask is None else v * mask[..., None].to(v.dtype)
        left = (self.kernel_size - 1) // 2 + self.sanm_shift
        right = self.kernel_size - 1 - left
        f = self.fsmn_block(F.pad(inp.transpose(1, 2), (left, right)))
        f = f.transpose(1, 2) + inp
        if mask is not None:
            f = f * mask[..., None].to(f.dtype)
        qh = q.reshape(b, t, self.heads, d_k).transpose(1, 2) * d_k ** -0.5
        kh = k.reshape(b, t, self.heads, d_k).transpose(1, 2)
        vh = v.reshape(b, t, self.heads, d_k).transpose(1, 2)
        scores = qh @ kh.transpose(-1, -2)  # (B, h, T, T)
        if mask is not None:
            key_ok = mask[:, None, None, :].bool()
            scores = scores.masked_fill(~key_ok, torch.finfo(
                scores.dtype).min)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn * key_ok.to(attn.dtype)
        out = (attn @ vh).transpose(1, 2).reshape(b, t, n)
        return self.linear_out(out) + f


class FeedForward(nn.Module):
    def __init__(self, size: int, linear_units: int):
        super().__init__()
        self.w_1 = nn.Linear(size, linear_units)
        self.w_2 = nn.Linear(linear_units, size)

    def forward(self, x):
        return self.w_2(F.relu(self.w_1(x)))


class SANMLayer(nn.Module):
    """EncoderLayerSANM, normalize_before: the attention's residual only
    when ``in_size == size``; the feed-forward's always."""

    def __init__(self, size: int, heads: int, linear_units: int,
                 kernel_size: int, sanm_shift: int = 0,
                 in_size: Optional[int] = None):
        super().__init__()
        self.in_size = size if in_size is None else in_size
        self.size = size
        self.norm1 = nn.LayerNorm(self.in_size, eps=1e-6)
        self.self_attn = SANMAttention(self.in_size, size, heads,
                                       kernel_size, sanm_shift)
        self.norm2 = nn.LayerNorm(size, eps=1e-6)
        self.feed_forward = FeedForward(size, linear_units)

    def forward(self, x, mask=None):
        h = self.self_attn(self.norm1(x), mask)
        x = x + h if self.in_size == self.size else h
        return x + self.feed_forward(self.norm2(x))


class SANMEncoder(nn.Module):
    """SenseVoiceEncoderSmall. ``forward(feats (B, T, 560), mask=None)`` ->
    (encoder_out after the tp layers and ``tp_norm``, or None with
    ``tp=False``; hidden_out, the ``after_norm`` trunk output; hiddens
    (num_blocks, B, T, 512), the trunk layers' outputs)."""

    def __init__(self, config: SANMConfig):
        super().__init__()
        cfg = self.config = config

        def layer(in_size=None):
            return SANMLayer(cfg.output_size, cfg.attention_heads,
                             cfg.linear_units, cfg.kernel_size,
                             cfg.sanm_shift, in_size)

        self.encoders0 = nn.ModuleList([layer(cfg.input_size)])
        self.encoders = nn.ModuleList(
            [layer() for _ in range(cfg.num_blocks - 1)])
        self.after_norm = nn.LayerNorm(cfg.output_size, eps=1e-6)
        self.tp_encoders = nn.ModuleList(
            [layer() for _ in range(cfg.tp_blocks)])
        self.tp_norm = nn.LayerNorm(cfg.output_size, eps=1e-6)

    def forward(self, feats, mask=None, tp: bool = True):
        cfg = self.config
        x = feats * cfg.output_size ** 0.5
        x = x + sinusoidal_pe(x.shape[1], cfg.input_size, x.dtype,
                              x.device)[None]
        x = self.encoders0[0](x, mask)
        hiddens = [x]
        for enc in self.encoders:
            x = enc(x, mask)
            hiddens.append(x)
        hidden_out = self.after_norm(x)
        encoder_out = None
        if tp:
            y = hidden_out
            for enc in self.tp_encoders:
                y = enc(y, mask)
            encoder_out = self.tp_norm(y)
        return encoder_out, hidden_out, torch.stack(hiddens)


class SenseVoiceSemanticEncoder(nn.Module):
    """The teacher as FlexiCodec reads it: the 4 query frames prepended,
    the trunk run, the queries stripped. (B, T, 560) -> (B, T, 512), the
    ``after_norm`` output; ``layer_mean=(lo, hi)`` averages the trunk
    layers [lo, hi) instead. The tp layers do not run here."""

    def __init__(self, config: SANMConfig, layer_mean=None):
        super().__init__()
        self.config, self.layer_mean = config, layer_mean
        self.embed = nn.Embedding(config.embed_vocab, config.input_size)
        self.encoder = SANMEncoder(config)

    def forward(self, feats, lengths=None):
        cfg = self.config
        ids = torch.tensor([cfg.lang_id, 1, 2, cfg.textnorm_id],
                           device=feats.device)
        queries = self.embed(ids)[None].to(feats.dtype).expand(
            feats.shape[0], -1, -1)
        x = torch.cat([queries, feats], dim=1)
        mask = None
        if lengths is not None:
            mask = (torch.arange(x.shape[1], device=x.device)[None]
                    < (lengths + 4)[:, None]).to(feats.dtype)
        _, hidden_out, hiddens = self.encoder(x, mask, tp=False)
        if self.layer_mean is not None:
            lo, hi = self.layer_mean
            return hiddens[lo:hi].mean(0)[:, 4:]
        return hidden_out[:, 4:]
