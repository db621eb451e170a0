"""HCodec-1.0: the dual-stream (acoustic + semantic) codec at 16 kHz, 25 Hz
tokens (hop 640).

Port of ``PriorNet``, ``CodecDecoder10``, ``HCodecConfig``,
``hcodec10_config`` and the inference methods of ``HCodec`` in
``unified_audio_tpu/models/hcodec/codec.py``: a SEANet encoder and a
semantic encoder, a ``ResidualVQ`` per stream, and a ConvNeXt/ISTFT decoder
of the two streams' concatenated embeddings. Channels-last. Parameter names
follow the reference layout that ``export_hcodec10_state_dict`` writes
(``encoder.model.{i}``, ``quantizer.layers.{i}._codebook.embed``,
``decoder.prior_net.{i}``, ``decoder.post_net.{i}``). HCodec-2.0 (the STFT
encoder) and the training forward (``SemanticDecoder``, losses) are not
ported yet, and neither is the causal variant.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from ...nn.blocks import ConvNeXtStack, GroupNorm, ResnetBlock, SEANetEncoder
from ...nn.conv import SubPixelConvTranspose1d
from ...nn.heads import ISTFTHead
from ...nn.transformer import Transformer
from ...ops.quant import ResidualVQ
from .semantic import SemanticEncoder


class PriorNet(nn.Sequential):
    """2 Resnet -> 2-layer hybrid transformer -> 2 Resnet -> GroupNorm(32),
    at the reference's indices 0, 1, 3, 5, 6, 7; its layout transposes (2,
    4) are ``Identity`` channels-last."""

    def __init__(self, dim: int):
        super().__init__(
            ResnetBlock(dim), ResnetBlock(dim), nn.Identity(),
            Transformer(dim, min(dim * 4, 4096),
                        dim // 64 if dim % 64 == 0 else 8, 2),
            nn.Identity(), ResnetBlock(dim), ResnetBlock(dim),
            GroupNorm(32, dim, eps=1e-6))


class CodecDecoder10(nn.Module):
    """Sub-pixel x2 upsampling embed -> prior net -> LayerNorm -> ConvNeXt
    stack -> LayerNorm -> ISTFT head. (B, T, in_dim) -> (B, 2 T hop)."""

    def __init__(self, in_dim: int, dim: int = 768,
                 intermediate_dim: int = 2304, convnext_layers: int = 12,
                 n_fft: int = 1280, hop_length: int = 320):
        super().__init__()
        self.embed = SubPixelConvTranspose1d(in_dim, dim, 5, stride=2)
        self.prior_net = PriorNet(dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.post_net = ConvNeXtStack(dim, intermediate_dim, convnext_layers)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = ISTFTHead(dim, n_fft, hop_length)

    def forward(self, x):
        x = self.norm(self.prior_net(self.embed(x)))
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


class HCodec(nn.Module):
    """Dual-stream codec at inference.

    encode(wav (B, L, 1), feat (B, 2 T, feat_dim)) -> (acoustic, semantic)
    codes, each (B, T, nq); decode(acoustic, semantic) -> wav (B, L)."""

    def __init__(self, config: HCodecConfig = HCodecConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.version != "1.0" or cfg.causal:
            raise NotImplementedError(
                f"HCodec-{cfg.version}{' causal' if cfg.causal else ''} is "
                "not ported yet (ROADMAP Queue 1); the port runs the "
                "non-causal HCodec-1.0")
        self.encoder = SEANetEncoder(cfg.latent_dim, cfg.seanet_filters,
                                     cfg.seanet_ratios)
        self.decoder = CodecDecoder10(
            2 * cfg.latent_dim, cfg.decoder_dim, cfg.decoder_intermediate_dim,
            cfg.decoder_convnext_layers, cfg.n_fft, cfg.istft_hop)
        self.quantizer = ResidualVQ(cfg.latent_dim, cfg.codebook_size,
                                    cfg.num_quantizers)
        self.semantic_quantizer = ResidualVQ(cfg.latent_dim,
                                             cfg.codebook_size,
                                             cfg.num_quantizers)
        self.semantic_encoder = SemanticEncoder(
            cfg.feat_dim, cfg.semantic_encode_channels, cfg.latent_dim,
            cfg.semantic_ratios, cfg.semantic_strides)

    def encode_latents(self, wav, feat):
        """-> (acoustic latents, semantic latents), each (B, T, latent_dim)."""
        return self.encoder(wav), self.semantic_encoder(feat)

    def encode(self, wav, feat):
        emb, semantic_emb = self.encode_latents(wav, feat)
        return (self.quantizer.encode(emb),
                self.semantic_quantizer.encode(semantic_emb))

    def decode(self, acoustic_codes, semantic_codes):
        return self.decoder(torch.cat(
            [self.quantizer.decode(acoustic_codes),
             self.semantic_quantizer.decode(semantic_codes)], dim=-1))
