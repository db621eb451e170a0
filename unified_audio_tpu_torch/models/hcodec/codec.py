"""HCodec-1.0 and 2.0: the dual-stream (acoustic + semantic) codecs.

* HCodec-1.0: 16 kHz, 25 Hz tokens (hop 640), a SEANet encoder, 4 x 1024
  codes a stream.
* HCodec-2.0: 48 kHz, 12.5 Hz tokens (hop 3840), an STFT-domain encoder
  (``CodecEncoder20``) and a repeat-interleave decoder (``CodecDecoder20``),
  16 x 1024 codes a stream.

Port of ``PriorNet``, ``CodecDecoder10``, ``CodecEncoder20``,
``CodecDecoder20``, ``HCodecConfig``, ``hcodec10_config``,
``hcodec20_config`` and ``HCodec`` in
``unified_audio_tpu/models/hcodec/codec.py``: an acoustic and a semantic
encoder, a ``ResidualVQ`` per stream, and a ConvNeXt/ISTFT decoder of the
two streams' concatenated embeddings; built with ``trainable`` also the
training forward (``HCodec.forward``: the EMA quantizers with quantizer
dropout, the ``SemanticDecoder`` target and the commitment losses).
Channels-last. Parameter names follow the reference layout that
``export_hcodec10_state_dict`` and ``export_hcodec20_state_dict`` write
(``encoder.model.{i}`` or ``encoder.prior_net.{i}``,
``quantizer.layers.{i}._codebook.embed``, ``decoder.prior_net.{i}``,
``decoder.post_net.{i}``).

``causal`` (``HCodecConfig.causal``) builds every conv with its causal
left pad and every transformer with the causal mask, as the JAX package
does; the parameters and their names do not change. As in the JAX package,
the decoder is not causal end to end: ``PriorNet``'s GroupNorms take their
statistics over the whole clip and the ISTFT head has no causal form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...nn.blocks import ConvNeXtStack, GroupNorm, ResnetBlock, SEANetEncoder
from ...nn.conv import CausalConv1d, SubPixelConvTranspose1d
from ...nn.heads import ISTFTHead
from ...nn.transformer import Transformer
from ...ops import dsp
from ...ops.quant import ResidualVQ
from ...utils.profiling import span
from .semantic import SemanticDecoder, SemanticEncoder


class PriorNet(nn.Sequential):
    """2 Resnet -> 2-layer hybrid transformer -> 2 Resnet -> GroupNorm(32),
    at the reference's indices 0, 1, 3, 5, 6, 7; its layout transposes (2,
    4) are ``Identity`` channels-last."""

    def __init__(self, dim: int, causal: bool = False):
        super().__init__(
            ResnetBlock(dim, causal), ResnetBlock(dim, causal), nn.Identity(),
            Transformer(dim, min(dim * 4, 4096),
                        dim // 64 if dim % 64 == 0 else 8, 2, causal=causal),
            nn.Identity(), ResnetBlock(dim, causal), ResnetBlock(dim, causal),
            GroupNorm(32, dim, eps=1e-6))


class CodecDecoder10(nn.Module):
    """Sub-pixel x2 upsampling embed -> prior net -> LayerNorm -> ConvNeXt
    stack -> LayerNorm -> ISTFT head. (B, T, in_dim) -> (B, 2 T hop)."""

    def __init__(self, in_dim: int, dim: int = 768,
                 intermediate_dim: int = 2304, convnext_layers: int = 12,
                 n_fft: int = 1280, hop_length: int = 320,
                 causal: bool = False):
        super().__init__()
        self.embed = SubPixelConvTranspose1d(in_dim, dim, 5, stride=2,
                                             causal=causal)
        self.prior_net = PriorNet(dim, causal)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.post_net = ConvNeXtStack(dim, intermediate_dim, convnext_layers,
                                      causal)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = ISTFTHead(dim, n_fft, hop_length)

    def forward(self, x):
        x = self.norm(self.prior_net(self.embed(x)))
        return self.head(self.final_layer_norm(self.post_net(x)))


class CodecEncoder20(nn.Module):
    """HCodec-2.0's STFT-domain encoder: the wav zero-padded by (n_fft -
    hop) / 2 a side -> complex STFT (no centering) -> [log |S| (|S| clipped
    at 1e-5) || angle(S) / pi] -> conv k3 embed -> LayerNorm -> ConvNeXt
    stack -> transformer (at ``post_net.1``) -> LayerNorm -> conv of kernel
    2 s + 1 and stride s = 50 Hz / target rate. (B, L) -> (B, L / (hop s),
    dimension)."""

    def __init__(self, dim: int = 1536, intermediate_dim: int = 4608,
                 dimension: int = 512, n_fft: int = 1920,
                 hop_length: int = 960, convnext_layers: int = 24,
                 target_frame_rate: float = 12.5, causal: bool = False):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        # 2 (n_fft / 2 + 1) features in
        self.embed = CausalConv1d(n_fft + 2, dim, 3, causal)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.prior_net = ConvNeXtStack(dim, intermediate_dim, convnext_layers,
                                       causal)
        self.post_net = nn.Sequential(
            nn.Identity(), Transformer(dim, min(dim * 4, 4096), dim // 64, 2,
                                       causal=causal),
            nn.Identity())
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)
        stride = int(50 / target_frame_rate)
        self.out = CausalConv1d(dim, dimension, 2 * stride + 1, causal,
                                stride=stride)

    def forward(self, x):
        # the STFT and its features are an fp32 island: a bf16 wav enters as
        # its fp32 values and the features leave in the wav's dtype
        pad = (self.n_fft - self.hop_length) // 2
        spec = dsp.stft(F.pad(x.float(), (pad, pad)), self.n_fft,
                        self.hop_length)  # (B, F, T)
        h = torch.cat([spec.abs().clamp(min=1e-5).log(),
                       spec.angle() / math.pi], dim=-2).transpose(1, 2)
        h = h.to(x.dtype)
        h = self.prior_net(self.norm(self.embed(h)))
        return self.out(self.final_layer_norm(self.post_net(h)))


class CodecDecoder20(nn.Module):
    """HCodec-2.0's decoder: each frame repeated 50 Hz / target rate times
    (repeat-interleave on time) -> conv embed (kernel factor + 1) -> prior
    net -> LayerNorm -> ConvNeXt stack -> LayerNorm -> ISTFT head.
    (B, T, in_dim) -> (B, T factor hop)."""

    def __init__(self, in_dim: int, dim: int = 1536,
                 intermediate_dim: int = 4608, convnext_layers: int = 32,
                 n_fft: int = 1920, hop_length: int = 960,
                 target_frame_rate: float = 12.5, causal: bool = False):
        super().__init__()
        self.factor = int(50 / target_frame_rate)
        self.embed = CausalConv1d(in_dim, dim, self.factor + 1, causal)
        self.prior_net = PriorNet(dim, causal)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.post_net = ConvNeXtStack(dim, intermediate_dim, convnext_layers,
                                      causal)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = ISTFTHead(dim, n_fft, hop_length)

    def forward(self, x):
        x = self.embed(x.repeat_interleave(self.factor, dim=1))
        x = self.norm(self.prior_net(x))
        return self.head(self.final_layer_norm(self.post_net(x)))


@dataclass(frozen=True)
class HCodecConfig:
    """The JAX package's config, field for field. Defaults are the shipped
    HCodec-1.0 model."""

    version: str = "1.0"
    sample_rate: int = 16000
    hop_length: int = 640  # samples per token (25 Hz)
    latent_dim: int = 512
    seanet_filters: int = 32
    # constructor-order ratios; the SEANet encoder applies them reversed
    seanet_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    codebook_size: int = 1024
    num_quantizers: int = 4
    quantize_dropout: bool = True  # training only
    decoder_dim: int = 768
    decoder_intermediate_dim: int = 2304
    decoder_convnext_layers: int = 12
    n_fft: int = 1280
    istft_hop: int = 320
    feat_dim: int = 768
    semantic_encode_channels: int = 768
    semantic_ratios: Tuple[float, ...] = (1, 1)
    semantic_strides: Tuple[int, ...] = (2, 1)
    # HCodec-2.0 only
    encoder_dim: int = 1536
    encoder_intermediate_dim: int = 4608
    encoder_convnext_layers: int = 24
    target_frame_rate: float = 12.5
    causal: bool = False


def hcodec10_config(**kw) -> HCodecConfig:
    return HCodecConfig(**kw)


def hcodec20_config(**kw) -> HCodecConfig:
    """HCodec-2.0, the 48 kHz large 12.5 Hz model: 16 x 1024 codes a
    stream, 1536-wide encoder (24 ConvNeXt layers) and decoder (32)."""
    base = dict(
        version="2.0", sample_rate=48000, hop_length=3840,  # 48000 / 12.5
        latent_dim=512, codebook_size=1024, num_quantizers=16,
        quantize_dropout=False, decoder_dim=1536,
        decoder_intermediate_dim=4608, decoder_convnext_layers=32,
        n_fft=1920, istft_hop=960, semantic_encode_channels=1536,
        semantic_ratios=(1, 1, 1), semantic_strides=(2, 1, 2),
        encoder_dim=1536, encoder_intermediate_dim=4608,
        encoder_convnext_layers=24, target_frame_rate=12.5)
    base.update(kw)
    return HCodecConfig(**base)


class HCodec(nn.Module):
    """Dual-stream codec.

    encode(wav (B, L, 1), feat (B, Tf, feat_dim)) -> (acoustic, semantic)
    codes, each (B, T, nq); decode(acoustic, semantic) -> wav (B, L). Tf is
    2 T for 1.0 and 4 T for 2.0 (50 Hz SSL frames of the 16 kHz audio).

    ``trainable`` builds the training state as the JAX package trains it:
    the SEANet encoder's convs as weight norm (g, v), the codebooks' EMA
    buffers and the ``semantic_decoder``; ``forward(wav, feat, train)``
    then gives (recon, pred_feat, commit). Without it the codec is the
    inference model (weight norm folded, no EMA state, no semantic
    decoder), what ``utils/convert.py hcodec_inference_keys`` loads."""

    def __init__(self, config: HCodecConfig = HCodecConfig(),
                 trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        if cfg.version not in ("1.0", "2.0"):
            raise NotImplementedError(
                f"HCodec-{cfg.version} is not an HCodec-1.0 or 2.0 config "
                "(HCodec-1.5 is models/hcodec/adaptive.py AdaptiveHCodec)")
        if cfg.version == "1.0":
            self.encoder = SEANetEncoder(cfg.latent_dim, cfg.seanet_filters,
                                         cfg.seanet_ratios,
                                         weight_norm=trainable,
                                         causal=cfg.causal)
            self.decoder = CodecDecoder10(
                2 * cfg.latent_dim, cfg.decoder_dim,
                cfg.decoder_intermediate_dim, cfg.decoder_convnext_layers,
                cfg.n_fft, cfg.istft_hop, cfg.causal)
        else:
            self.encoder = CodecEncoder20(
                cfg.encoder_dim, cfg.encoder_intermediate_dim, cfg.latent_dim,
                cfg.n_fft, cfg.istft_hop, cfg.encoder_convnext_layers,
                cfg.target_frame_rate, cfg.causal)
            self.decoder = CodecDecoder20(
                2 * cfg.latent_dim, cfg.decoder_dim,
                cfg.decoder_intermediate_dim, cfg.decoder_convnext_layers,
                cfg.n_fft, cfg.istft_hop, cfg.target_frame_rate, cfg.causal)
        vq = dict(ema=trainable, quantize_dropout=cfg.quantize_dropout)
        self.quantizer = ResidualVQ(cfg.latent_dim, cfg.codebook_size,
                                    cfg.num_quantizers, **vq)
        self.semantic_quantizer = ResidualVQ(cfg.latent_dim,
                                             cfg.codebook_size,
                                             cfg.num_quantizers, **vq)
        self.semantic_encoder = SemanticEncoder(
            cfg.feat_dim, cfg.semantic_encode_channels, cfg.latent_dim,
            cfg.semantic_ratios, cfg.semantic_strides)
        if trainable:
            self.semantic_decoder = SemanticDecoder(
                cfg.latent_dim, cfg.feat_dim, cfg.semantic_encode_channels,
                cfg.semantic_ratios, cfg.semantic_strides)

    def forward(self, wav, feat, train: bool = True, generator=None):
        """wav (B, L, 1), feat (B, Tf, feat_dim) -> (recon (B, L'),
        pred_feat (B, Tf, feat_dim), commit ()): commit is the mean of the
        acoustic layers' commitment losses plus the mean of the semantic
        layers' (a dropped layer counts as a zero). In training the
        quantizers update their EMA buffers and ``generator`` draws
        k-means' rows and the dropout cutoffs."""
        emb, semantic_emb = self.encode_latents(wav, feat)
        quantized, _, commit = self.quantizer(emb, train, generator)
        quantized_sem, _, commit_sem = self.semantic_quantizer(
            semantic_emb, train, generator)
        recon = self.decoder(torch.cat([quantized, quantized_sem], dim=-1))
        return (recon, self.semantic_decoder(quantized_sem),
                commit.mean() + commit_sem.mean())

    def encode_latents(self, wav, feat):
        """-> (acoustic latents, semantic latents), each (B, T, latent_dim);
        the 2.0 encoder takes the wav without its channel axis."""
        acoustic = self.encoder(wav if self.config.version == "1.0"
                                else wav[..., 0])
        return acoustic, self.semantic_encoder(feat)

    def encode(self, wav, feat):
        with span("codec.encode"):
            with span("codec.encode.latents"):
                emb, semantic_emb = self.encode_latents(wav, feat)
            with span("codec.encode.quantize"):
                return (self.quantizer.encode(emb),
                        self.semantic_quantizer.encode(semantic_emb))

    def decode(self, acoustic_codes, semantic_codes):
        return self.decoder(torch.cat(
            [self.quantizer.decode(acoustic_codes),
             self.semantic_quantizer.decode(semantic_codes)], dim=-1))
