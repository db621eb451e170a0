"""FlexiCodec / DualCodec: a DAC acoustic codec coupled to a semantic stream.

Port of ``unified_audio_tpu/models/hcodec/flexicodec.py``: ``DACEncoderBlock``,
``DACEncoder``, ``DACVectorQuantize``, ``DACRVQ``, ``FlexiFSQ``,
``SemanticEncoderCNX``, ``SemanticDecoderCNX``, ``FlexiCodecConfig``,
``FlexiCodec`` (``encode``, ``decode`` and the training ``forward``),
``fbank_semantic``, ``sensevoice_semantic``, ``sensevoice_teacher_semantic``,
``match_frame_rate`` and ``teacher_features``.

* Acoustic path: the DAC conv encoder, a residual stack of projected,
  L2-normalized VQ layers (``codebook_dim`` 8: each layer's search is the
  plain fp32 argmin of ``|e|^2 - 2 e.c + |c|^2`` over unit vectors, as the
  JAX package keeps it outside Pallas), the DAC decoder (``WaveGenerator``).
* Semantic path: a weight-normed 1x1 conv and ConvNeXt blocks, FSQ (the
  vendored bound with ``tan`` and ``1 - eps``), ConvNeXt blocks and a 1x1
  conv back to the DAC latent.
* DualCodec coupling: the acoustic RVQ quantizes ``encoder(x) -
  decoded semantic``; decode sums the two streams. Codes at the frame rate.
* Aligned mode (``use_similarity_alignment``): HCodec-1.5's similarity
  groups and query-token aggregators (``models/hcodec/adaptive.py``), group
  codes with their lengths injected, padding groups zeroed before the
  semantic ConvNeXt decoder on both sides, and the Mimi bottleneck.
* ``is_causal``: the ConvNeXt adapters' depthwise convs pad on the left.
* Training forward (``forward``): the commitment and codebook losses of
  the DAC RVQ and, given a frozen teacher's features, the distillation of
  the quantized semantic stream toward them (in the aligned mode averaged
  over the valid groups only). ``trainable`` builds every weight-normed
  conv of the reference (the DAC encoder, RVQ projections and decoder, the
  adapters' 1x1 convs) as (g, v), the form the JAX package trains.

Module names follow the reference layout that
``export_flexicodec_state_dict`` writes (``dac.encoder.block.{i}``,
``dac.quantizer.quantizers.{i}.codebook.weight``, ``dac.decoder.model.{i}``,
``convnext_encoder.{i}``, ``semantic_vq.fsq.project_in``); weight norm is
folded on loading (``utils/convert.py flexicodec_inference_keys``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...nn.blocks import ConvNeXtBlock, DACResidualUnit, Snake1d, WaveGenerator
from ...nn.conv import Conv1d
from ...nn.mimi import MimiProjectedTransformer
from ...ops import dsp
from ...ops.fbank import SenseVoiceFrontend
from .adaptive import (QueryTokenAggregator, degroup, extract_length,
                       group_ids_from_lengths, inject_length,
                       similarity_group_ids)


# ---------------------------------------------------------------------------
# DAC acoustic path
# ---------------------------------------------------------------------------

class DACEncoderBlock(nn.Module):
    """3 dilated residual units -> Snake -> strided conv (kernel 2 s, pad
    ceil(s / 2)), at ``block.{0..4}``."""

    def __init__(self, dim: int, output_dim: int, stride: int,
                 weight_norm: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm)
        self.block = nn.Sequential(
            *[DACResidualUnit(dim, d, **wn) for d in (1, 3, 9)], Snake1d(dim),
            Conv1d(dim, output_dim, 2 * stride, stride=stride,
                   padding=-(-stride // 2), **wn))

    def forward(self, x):
        return self.block(x)


class DACEncoder(nn.Module):
    """wav (B, T, 1) -> latents (B, T / prod(rates), latent_dim)."""

    def __init__(self, d_model: int = 64, rates: Sequence[int] = (2, 4, 8, 8),
                 latent_dim: int = 1024, weight_norm: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm)
        layers, dim = [Conv1d(1, d_model, 7, padding=3, **wn)], d_model
        for s in rates:
            layers.append(DACEncoderBlock(dim, 2 * dim, s, **wn))
            dim *= 2
        layers += [Snake1d(dim), Conv1d(dim, latent_dim, 3, padding=1, **wn)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        return self.block(x)


class DACVectorQuantize(nn.Module):
    """in_proj 1x1 -> nearest unit codebook row of the unit input ->
    out_proj 1x1."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 weight_norm: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm)
        self.in_proj = Conv1d(input_dim, codebook_dim, 1, padding=0, **wn)
        self.out_proj = Conv1d(codebook_dim, input_dim, 1, padding=0, **wn)
        self.codebook = nn.Embedding(codebook_size, codebook_dim)

    def decode_code(self, idx):
        """Indices (...) -> their codebook rows (..., codebook_dim)."""
        return self.codebook(idx.long())

    def nearest(self, z_e):
        """(B, T, cd) -> (B, T) int64: argmin of ``|e|^2 - 2 e.c + |c|^2``
        over the L2-normalized input and codebook (norms floored at
        1e-12), fp32, the first of equal minima."""
        enc = z_e / torch.clamp(z_e.square().sum(-1, keepdim=True).sqrt(),
                                min=1e-12)
        cb = self.codebook.weight
        cb = cb / torch.clamp(cb.square().sum(-1, keepdim=True).sqrt(),
                              min=1e-12)
        dist = (enc.square().sum(-1, keepdim=True)
                - 2 * torch.einsum("btd,nd->btn", enc, cb)
                + cb.square().sum(-1)[None, None])
        return dist.argmin(-1)

    def forward(self, z):
        """z (B, T, D) -> (z_q (B, T, D), commitment (B,), codebook loss
        (B,), indices (B, T)): the losses are each row's mean of
        (z_e - sg(c))^2 and (c - sg(z_e))^2 for the chosen rows c, and z_q
        the straight-through ``out_proj(z_e + sg(c - z_e))``, summed as the
        JAX package rounds it."""
        z_e = self.in_proj(z)
        idx = self.nearest(z_e)
        z_qp = self.codebook(idx)
        commitment = (z_e - z_qp.detach()).square().mean((1, 2))
        codebook_loss = (z_qp - z_e.detach()).square().mean((1, 2))
        return (self.out_proj(z_e + (z_qp - z_e).detach()), commitment,
                codebook_loss, idx)


class DACRVQ(nn.Module):
    """Residual stack of :class:`DACVectorQuantize` (no quantizer
    dropout, as in the JAX package)."""

    def __init__(self, input_dim: int, n_codebooks: int, codebook_size: int,
                 codebook_dim: int, weight_norm: bool = False):
        super().__init__()
        self.quantizers = nn.ModuleList([
            DACVectorQuantize(input_dim, codebook_size, codebook_dim,
                              weight_norm)
            for _ in range(n_codebooks)])

    def forward(self, z):
        """z (B, T, D) -> (z_q (B, T, D), codes (B, T, nq) int32,
        commitment (), codebook loss ()): each layer quantizes the residual
        the layers before it leave; each loss is the sum over the layers of
        the batch mean."""
        z_q, residual, codes = 0.0, z, []
        commitment = codebook_loss = 0.0
        for q in self.quantizers:
            z_q_i, c_i, cb_i, idx = q(residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            commitment = commitment + c_i.mean()
            codebook_loss = codebook_loss + cb_i.mean()
            codes.append(idx)
        return z_q, torch.stack(codes, -1).int(), commitment, codebook_loss

    def encode(self, z):
        """z (B, T, D) -> codes (B, T, nq) int32."""
        return self(z)[1]

    def from_codes(self, codes):
        """(B, T, nq) -> (B, T, D)."""
        z_q = 0.0
        for i, q in enumerate(self.quantizers):
            z_q = z_q + q.out_proj(q.codebook(codes[..., i].long()))
        return z_q


# ---------------------------------------------------------------------------
# Semantic path
# ---------------------------------------------------------------------------

class FlexiFSQ(nn.Module):
    """The vendored FSQ: Linear ``project_in``/``project_out`` (when the
    width is not the number of levels) around per-channel rounding. Its
    bound is ``tanh(z + tan(offset / half_l)) * half_l - offset`` with
    ``half_l = (levels - 1)(1 - eps) / 2``: ``tan`` and ``1 - eps``, where
    BiCodec's FSQ has ``atanh`` and ``1 + eps`` (kept for checkpoint
    parity)."""

    def __init__(self, input_dim: int, levels: Sequence[int] = (8,) * 5):
        super().__init__()
        self.levels = tuple(levels)
        cd = len(self.levels)
        self.project = input_dim != cd
        if self.project:
            self.project_in = nn.Linear(input_dim, cd)
            self.project_out = nn.Linear(cd, input_dim)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))

    def _consts(self, dev):
        """(levels, basis, half widths), each (len(levels),) fp32."""
        levels = torch.tensor(self.levels, dtype=torch.float32, device=dev)
        basis = torch.tensor(np.concatenate(
            [[1], np.cumprod(self.levels[:-1])]).astype(np.float32),
            device=dev)
        half = torch.tensor([lv // 2 for lv in self.levels],
                            dtype=torch.float32, device=dev)
        return levels, basis, half

    def _in(self, x):
        return self.project_in(x) if self.project else x

    def _out(self, x):
        return self.project_out(x) if self.project else x

    def bound(self, z, eps: float = 1e-3):
        levels, _, _ = self._consts(z.device)
        half_l = (levels - 1) * (1 - eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        return torch.tanh(z + torch.tan(offset / half_l)) * half_l - offset

    def quantize(self, z):
        """Round the bounded value to the nearest level (half to even),
        straight through to ``z`` (``z + sg(round - z)``, the JAX package's
        sum), over the half width."""
        q = torch.round(self.bound(z))
        return (z + (q - z).detach()) / self._consts(z.device)[2]

    def codes_to_indices(self, zhat):
        _, basis, half = self._consts(zhat.device)
        return ((zhat * half + half) * basis).sum(-1).int()

    def from_indices(self, indices):
        """indices (...) -> ``project_out`` of the codes (..., D)."""
        levels, basis, half = self._consts(indices.device)
        nc = torch.remainder(torch.floor_divide(
            indices[..., None].float(), basis), levels)
        return self._out((nc - half) / half)

    def indices(self, x):
        """x (B, T, D) -> indices (B, T) int32."""
        return self.codes_to_indices(self.quantize(self._in(x)))

    def forward(self, x):
        """x (B, T, D) -> (``project_out`` of the codes (B, T, D), indices
        (B, T) int32); the gradient passes the rounding straight
        through."""
        codes = self.quantize(self._in(x))
        return self._out(codes), self.codes_to_indices(codes)


class SemanticEncoderCNX(nn.Sequential):
    """A 1x1 conv (ssl_dim -> convnext_dim) at index 0, then ConvNeXt
    blocks (intermediate 2048, no gamma; causal or not)."""

    def __init__(self, ssl_dim: int, convnext_dim: int, num_layers: int,
                 causal: bool = False, weight_norm: bool = False):
        super().__init__(
            Conv1d(ssl_dim, convnext_dim, 1, padding=0,
                   weight_norm=weight_norm),
            *[ConvNeXtBlock(convnext_dim, 2048, None, causal=causal)
              for _ in range(num_layers)])


class SemanticDecoderCNX(nn.Sequential):
    """ConvNeXt blocks (causal or not), then a 1x1 conv (convnext_dim ->
    out_dim) at index ``num_layers``."""

    def __init__(self, convnext_dim: int, out_dim: int, num_layers: int,
                 causal: bool = False, weight_norm: bool = False):
        super().__init__(
            *[ConvNeXtBlock(convnext_dim, 2048, None, causal=causal)
              for _ in range(num_layers)],
            Conv1d(convnext_dim, out_dim, 1, padding=0,
                   weight_norm=weight_norm))


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FlexiCodecConfig:
    """The JAX package's config, field for field."""

    sample_rate: int = 24000
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    latent_dim: int = 1024  # encoder_dim * 2 ** len(rates)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    ssl_dim: int = 1024
    convnext_dim: int = 768
    convnext_layers: int = 4
    fsq_levels: Tuple[int, ...] = (8, 8, 8, 8, 8)
    decode_semantic_for_codec: bool = True
    is_causal: bool = False
    semantic_downsample_factor: int = 2
    use_similarity_alignment: bool = False
    similarity_threshold: float = 0.9
    max_tokens_per_group: int = 8
    use_query_token_aggregator: bool = False
    agg_layers: int = 6
    agg_heads: int = 8
    agg_ff: int = 2048
    agg_context: int = 24
    use_bottleneck_transformer: bool = False
    bottleneck_layers: int = 6
    bottleneck_heads: int = 8
    bottleneck_ff: int = 2048
    bottleneck_context: int = 24
    lambda_distill: float = 15.0

    @property
    def hop_length(self):
        return int(np.prod(self.encoder_rates))


class _DAC(nn.Module):
    """The reference's ``dac`` submodule: encoder, quantizer, decoder."""

    def __init__(self, cfg: FlexiCodecConfig, weight_norm: bool = False):
        super().__init__()
        wn = dict(weight_norm=weight_norm)
        self.encoder = DACEncoder(cfg.encoder_dim, cfg.encoder_rates,
                                  cfg.latent_dim, **wn)
        self.quantizer = DACRVQ(cfg.latent_dim, cfg.n_codebooks,
                                cfg.codebook_size, cfg.codebook_dim, **wn)
        self.decoder = WaveGenerator(
            cfg.latent_dim, cfg.decoder_dim, cfg.decoder_rates,
            tuple(2 * r for r in cfg.decoder_rates), **wn)


class _SemanticVQ(nn.Module):
    """The reference's ``semantic_vq`` wrapper around its FSQ."""

    def __init__(self, cfg: FlexiCodecConfig):
        super().__init__()
        self.fsq = FlexiFSQ(cfg.convnext_dim, cfg.fsq_levels)


class FlexiCodec(nn.Module):
    """``encode(wav (B, L), semantic (B, 2 T, ssl_dim))`` -> (acoustic,
    semantic) codes; ``decode`` -> wav (B, L). DualCodec mode: (B, T, nq)
    and (B, T, 1) at the frame rate; aligned mode: (B, G, ·) group codes
    with their lengths injected, -1 at padding groups. ``forward`` is the
    training forward; ``trainable`` builds the weight-normed convs as (g,
    v) (what ``utils/convert.py flexicodec_train_state_dict`` loads),
    without it they are folded (``flexicodec_inference_keys``)."""

    def __init__(self, config: FlexiCodecConfig = FlexiCodecConfig(),
                 trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        wn = dict(weight_norm=trainable)
        self.dac = _DAC(cfg, **wn)
        self.convnext_encoder = SemanticEncoderCNX(
            cfg.ssl_dim, cfg.convnext_dim, cfg.convnext_layers,
            cfg.is_causal, **wn)
        self.convnext_decoder = SemanticDecoderCNX(
            cfg.convnext_dim, cfg.latent_dim, cfg.convnext_layers,
            cfg.is_causal, **wn)
        self.semantic_vq = _SemanticVQ(cfg)
        if cfg.use_query_token_aggregator:
            agg = dict(num_heads=cfg.agg_heads, num_layers=cfg.agg_layers,
                       dim_feedforward=cfg.agg_ff, context=cfg.agg_context)
            self.semantic_aggregator = QueryTokenAggregator(cfg.ssl_dim,
                                                            **agg)
            self.acoustic_aggregator = QueryTokenAggregator(cfg.latent_dim,
                                                            **agg)
        if cfg.use_bottleneck_transformer:
            self.bottleneck_transformer = MimiProjectedTransformer(
                cfg.latent_dim, cfg.latent_dim, cfg.latent_dim,
                cfg.bottleneck_layers, cfg.bottleneck_heads,
                cfg.bottleneck_ff, causal=False,
                context=cfg.bottleneck_context)

    @property
    def fsq(self) -> FlexiFSQ:
        return self.semantic_vq.fsq

    def downsample_semantic(self, feats):
        """Mean over ``semantic_downsample_factor`` frames (B, T, C)."""
        f = self.config.semantic_downsample_factor
        if f == 1:
            return feats
        t = feats.shape[1] // f * f
        return feats[:, :t].reshape(feats.shape[0], t // f, f, -1).mean(2)

    def streams(self, wav, semantic_repr):
        """Both streams at one frame rate: (latents (B, T, D), semantic (B,
        T, ssl_dim)), trimmed to the shorter."""
        z = self.dac.encoder(wav[..., None])
        sem = self.downsample_semantic(semantic_repr)
        t = min(z.shape[1], sem.shape[1])
        return z[:, :t], sem[:, :t]

    def _semantic_decoded(self, sem_q):
        return (self.convnext_decoder(sem_q)
                if self.config.decode_semantic_for_codec else sem_q)

    def _group(self, z, sem, threshold):
        """-> (counts (B, G), aggregated semantic, aggregated latents,
        group ids (B, T))."""
        cfg = self.config
        gid = similarity_group_ids(
            sem, cfg.similarity_threshold if threshold is None else threshold,
            cfg.max_tokens_per_group)
        sem_agg, counts = self.semantic_aggregator(sem, gid)
        ac_agg, _ = self.acoustic_aggregator(z, gid)
        return counts, sem_agg, ac_agg, gid

    def _output(self, latent):
        if self.config.use_bottleneck_transformer:
            latent = self.bottleneck_transformer(latent)
        return self.dac.decoder(latent)[..., 0]

    def forward(self, wav, semantic_repr, teacher_feats=None,
                train: bool = True, threshold=None):
        """The training forward (``train`` changes nothing: the model has
        no dropout and no EMA state, as in the JAX package) -> a dict:
        "recons" (B, L), "acoustic_codes" (B, T or G, nq), "semantic_codes"
        (B, T or G) (plain codes, no lengths injected), "commit_loss" (the
        DAC RVQ's commitment plus codebook losses), "group_ids" (B, T) in
        the aligned mode else None, and with ``teacher_feats`` (B, 2 T, C),
        "distill_loss": ``lambda_distill`` times the mean square between
        the quantized semantic stream and the teacher's downsampled
        features (no gradient to the teacher), over the first min of their
        widths, in the aligned mode over the valid groups only."""
        cfg = self.config
        z, sem = self.streams(wav, semantic_repr)
        if cfg.use_similarity_alignment:
            counts, sem_agg, ac_agg, gid = self._group(z, sem, threshold)
        else:
            counts = gid = None
            sem_agg, ac_agg = sem, z
        sem_q, sem_codes = self.fsq(self.convnext_encoder(sem_agg))
        if counts is not None:
            # padding groups -> zero before the ConvNeXt decoder, as encode
            sem_q = torch.where((counts > 0)[..., None], sem_q, 0.0)
        sem_dec = self._semantic_decoded(sem_q)
        ac_q, ac_codes, commitment, codebook_loss = self.dac.quantizer(
            ac_agg - sem_dec)
        latent = ac_q + sem_dec
        if gid is not None:
            latent = degroup(latent, gid)
        out = {"recons": self._output(latent), "acoustic_codes": ac_codes,
               "semantic_codes": sem_codes,
               "commit_loss": commitment + codebook_loss, "group_ids": gid}
        if teacher_feats is not None:
            tgt = self.downsample_semantic(teacher_feats).detach()
            t = min(sem_dec.shape[1], tgt.shape[1], sem_q.shape[1])
            d = min(sem_q.shape[-1], tgt.shape[-1])
            se = (sem_q[:, :t, :d] - tgt[:, :t, :d]).square()
            if counts is not None:
                w = (counts[:, :t] > 0).to(se.dtype)[..., None]
                loss = (se * w).sum() / torch.clamp(w.sum() * d, min=1.0)
            else:
                loss = se.mean()
            out["distill_loss"] = cfg.lambda_distill * loss
        return out

    def encode(self, wav, semantic_repr, threshold=None):
        """-> (acoustic codes, semantic codes), int32."""
        cfg = self.config
        z, sem = self.streams(wav, semantic_repr)
        if not cfg.use_similarity_alignment:
            sem_codes = self.fsq.indices(self.convnext_encoder(sem))
            sem_dec = self._semantic_decoded(self.fsq.from_indices(sem_codes))
            return self.dac.quantizer.encode(z - sem_dec), sem_codes[..., None]
        counts, sem_agg, ac_agg, _ = self._group(z, sem, threshold)
        sem_codes = self.fsq.indices(self.convnext_encoder(sem_agg))
        # padding groups -> zero before the ConvNeXt decoder, as decode does
        sem_q = torch.where((counts > 0)[..., None],
                            self.fsq.from_indices(sem_codes), 0.0)
        ac_codes = self.dac.quantizer.encode(
            ac_agg - self._semantic_decoded(sem_q))
        return (inject_length(ac_codes, counts, cfg.codebook_size),
                inject_length(sem_codes[..., None], counts,
                              self.fsq.codebook_size))

    def decode(self, acoustic_codes, semantic_codes):
        """Inverse of :meth:`encode` -> wav (B, T hop)."""
        cfg = self.config
        if not cfg.use_similarity_alignment:
            sem_dec = self._semantic_decoded(
                self.fsq.from_indices(semantic_codes[..., 0]))
            return self._output(
                self.dac.quantizer.from_codes(acoustic_codes) + sem_dec)
        ac_plain, lengths = extract_length(acoustic_codes, cfg.codebook_size)
        sem_plain, _ = extract_length(semantic_codes,
                                      self.fsq.codebook_size)
        gid = group_ids_from_lengths(lengths, acoustic_codes.shape[1])
        sem_q = torch.where(
            (lengths > 0)[..., None],
            self.fsq.from_indices(sem_plain[..., 0].clamp(min=0)), 0.0)
        ac_q = self.dac.quantizer.from_codes(ac_plain.clamp(min=0))
        return self._output(degroup(ac_q + self._semantic_decoded(sem_q),
                                    gid))


# ---------------------------------------------------------------------------
# Semantic streams
# ---------------------------------------------------------------------------

def _tile(feats, out_dim: int):
    """Repeat the channels of (B, T, C) and keep the first ``out_dim``."""
    reps = -(-out_dim // feats.shape[-1])
    return feats.repeat(1, 1, reps)[..., :out_dim]


def fbank_semantic(wav, sample_rate: int = 16000, n_mels: int = 80,
                   hop: int = 160, out_dim: int = 1024):
    """The log-mel fallback: (B, T) -> (B, T / hop + 1, n_mels) tiled to
    ``out_dim`` (n_fft 512, window 400, slaney mel)."""
    mel = dsp.mel_spectrogram(wav, sample_rate, 512, 400, hop, 0.0,
                              sample_rate / 2, n_mels)
    return _tile(torch.log(mel + 1e-6).transpose(-1, -2), out_dim)


@functools.lru_cache(maxsize=8)
def _frontend(cmvn_file, sample_rate: int) -> SenseVoiceFrontend:
    """One frontend per CMVN file: the file is parsed on first use and its
    vectors stay on each device they were used on."""
    return SenseVoiceFrontend(cmvn_file=cmvn_file, sample_rate=sample_rate)


def sensevoice_semantic(wav, cmvn_file, out_dim: int = 1024,
                        sample_rate: int = 16000):
    """The teacher's frontend alone (fbank, LFR, CMVN from ``cmvn_file``):
    (B, T) -> (B, ceil(T_frames / 6), 560) tiled to ``out_dim``."""
    front = _frontend(cmvn_file, sample_rate)
    return _tile(front(wav), out_dim)


def sensevoice_teacher_semantic(encoder, wav, cmvn_file,
                                sample_rate: int = 16000,
                                out_dim: Optional[int] = None):
    """The whole teacher: the frontend into ``encoder`` (a
    ``SenseVoiceSemanticEncoder``): (B, T) -> (B, ceil(T_frames / 6), 512),
    tiled to ``out_dim`` if given."""
    front = _frontend(cmvn_file, sample_rate)
    with torch.no_grad():
        sem = encoder(front(wav))
    if out_dim is not None and sem.shape[-1] != out_dim:
        sem = _tile(sem, out_dim)
    return sem


def match_frame_rate(feats, num_frames: int):
    """Linearly resample (B, T, C) along time to ``num_frames`` frames (the
    model reads its semantic stream at twice the acoustic frame rate)."""
    t = feats.shape[1]
    if t == num_frames:
        return feats
    pos = torch.linspace(0.0, float(t - 1), num_frames, device=feats.device)
    lo = torch.clamp(torch.floor(pos).long(), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    w = (pos - lo.to(pos.dtype))[None, :, None]
    return feats[:, lo] * (1.0 - w) + feats[:, hi] * w


def teacher_features(ssl, wav):
    """The frozen teacher's target for ``FlexiCodec.forward``: HCodec's SSL
    features (the all-layer mean, signed |x|^0.3) of ``ssl`` (a
    ``models/ssl`` ``Wav2Vec2Model``, e.g. HuBERT) on ``wav`` (B, T), with
    no gradient -> (B, T / 320, hidden)."""
    from ..ssl.wav2vec2 import hubert_features

    with torch.no_grad():
        return hubert_features(ssl(wav))
