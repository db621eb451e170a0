# Frozen copy of unified_audio_tpu_torch/models/bicodec/bicodec.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""BiCodec: waveform <-> (semantic, global) tokens.

Port of ``unified_audio_tpu/models/bicodec/bicodec.py``: ``BiCodecConfig``,
``FeatEncoder``, ``FeatDecoder`` (the prenet), ``BiCodec.mel``,
``BiCodec.tokenize`` and ``BiCodec.detokenize``. Serving builds the decode
side only (``BiCodec(config)``); ``BiCodec(config, tokenize=True)`` also
builds the feature encoder, the quantizer's ``in_project`` and the speaker
encoder's ECAPA-TDNN and Perceiver, which UniSE's training tokenizes its
targets with. The postnet serves codec training and is not built.
Submodule names follow the reference state-dict layout (``encoder.*``,
``quantizer.*``, ``speaker_encoder.*``, ``prenet.*``, ``decoder.model.*``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from torch import nn

from .blocks import SamplingBlock, VocosBackbone, WaveGenerator
from . import dsp
from .quant import FactorizedVectorQuantize
from .speaker import SpeakerEncoder


@dataclass(frozen=True)
class BiCodecConfig:
    """Defaults follow the BiCodec shipped with UniSE."""

    sample_rate: int = 16000
    latent_hop_length: int = 320  # 50 Hz semantic tokens
    ref_segment_duration: float = 6.0
    mel_n_fft: int = 1024
    mel_win: int = 640
    mel_hop: int = 320
    mel_fmin: float = 10.0
    mel_fmax: float = 8000.0
    num_mels: int = 128
    feat_dim: int = 1024
    vocos_dim: int = 384
    vocos_intermediate_dim: int = 2048
    vocos_num_layers: int = 12
    latent_dim: int = 1024
    sample_ratios: Tuple[int, ...] = (1, 1)
    codebook_size: int = 8192
    codebook_dim: int = 8
    commitment: float = 0.25
    spk_out_dim: int = 1024
    spk_latent_dim: int = 128
    token_num: int = 32
    fsq_levels: Tuple[int, ...] = (4, 4, 4, 4, 4, 4)
    wave_channels: int = 1536
    wave_rates: Tuple[int, ...] = (8, 5, 4, 2)
    wave_kernels: Tuple[int, ...] = (16, 11, 8, 4)


class FeatEncoder(nn.Module):
    """Vocos backbone -> (sampling block + 2-layer Vocos) per ratio ->
    project. (B, T, in) -> (B, T, out)."""

    def __init__(self, input_channels: int, vocos_dim: int,
                 vocos_intermediate_dim: int, vocos_num_layers: int,
                 out_channels: int, sample_ratios: Sequence[int] = (1, 1)):
        super().__init__()
        self.encoder = VocosBackbone(input_channels, vocos_dim,
                                     vocos_intermediate_dim, vocos_num_layers)
        self.downsample = nn.ModuleList([
            nn.ModuleList([SamplingBlock(vocos_dim, vocos_dim,
                                         downsample_scale=r),
                           VocosBackbone(vocos_dim, vocos_dim,
                                         vocos_intermediate_dim, 2)])
            for r in sample_ratios])
        self.project = nn.Linear(vocos_dim, out_channels)

    def forward(self, x):
        x = self.encoder(x)
        for sampler, vocos in self.downsample:
            x = vocos(sampler(x))
        return self.project(x)


class FeatDecoder(nn.Module):
    """linear_pre -> (sampling block + 2-layer Vocos) per ratio ->
    conditioned Vocos backbone -> linear. (B, T, in), cond (B, C) ->
    (B, T, out)."""

    def __init__(self, input_channels: int, vocos_dim: int,
                 vocos_intermediate_dim: int, vocos_num_layers: int,
                 out_channels: int, condition_dim: Optional[int] = None,
                 sample_ratios: Sequence[int] = (1, 1)):
        super().__init__()
        self.linear_pre = nn.Linear(input_channels, vocos_dim)
        self.downsample = nn.ModuleList([
            nn.ModuleList([SamplingBlock(vocos_dim, vocos_dim,
                                         upsample_scale=r),
                           VocosBackbone(vocos_dim, vocos_dim,
                                         vocos_intermediate_dim, 2)])
            for r in sample_ratios])
        self.vocos_backbone = VocosBackbone(
            vocos_dim, vocos_dim, vocos_intermediate_dim, vocos_num_layers,
            condition_dim)
        self.linear = nn.Linear(vocos_dim, out_channels)

    def forward(self, x, condition=None):
        x = self.linear_pre(x)
        for sampler, vocos in self.downsample:
            x = vocos(sampler(x))
        return self.linear(self.vocos_backbone(x, condition))


class BiCodec(nn.Module):
    """The decode side of BiCodec, and with ``tokenize`` its tokenize side
    too."""

    def __init__(self, config: BiCodecConfig = BiCodecConfig(),
                 tokenize: bool = False):
        super().__init__()
        cfg = self.config = config
        if tokenize:
            self.encoder = FeatEncoder(
                cfg.feat_dim, cfg.vocos_dim, cfg.vocos_intermediate_dim,
                cfg.vocos_num_layers, cfg.latent_dim, cfg.sample_ratios)
        self.quantizer = FactorizedVectorQuantize(
            cfg.latent_dim, cfg.codebook_size, cfg.codebook_dim, tokenize)
        self.speaker_encoder = SpeakerEncoder(
            input_dim=cfg.num_mels, out_dim=cfg.spk_out_dim,
            latent_dim=cfg.spk_latent_dim, token_num=cfg.token_num,
            fsq_levels=cfg.fsq_levels, tokenize=tokenize)
        self.prenet = FeatDecoder(
            cfg.latent_dim, cfg.vocos_dim, cfg.vocos_intermediate_dim,
            cfg.vocos_num_layers, cfg.latent_dim,
            condition_dim=cfg.spk_out_dim, sample_ratios=cfg.sample_ratios)
        self.decoder = WaveGenerator(cfg.latent_dim, cfg.wave_channels,
                                     cfg.wave_rates, cfg.wave_kernels)

    def mel(self, wav):
        """The speaker branch's mel: (B, T) -> (B, frames, num_mels), slaney
        scale and norm."""
        cfg = self.config
        return dsp.mel_spectrogram(
            wav, cfg.sample_rate, cfg.mel_n_fft, cfg.mel_win, cfg.mel_hop,
            cfg.mel_fmin, cfg.mel_fmax, cfg.num_mels).transpose(-1, -2)

    def tokenize(self, feat, ref_wav):
        """feat (B, T, feat_dim), ref_wav (B, T_ref) -> (semantic (B, T),
        global (B, token_num, nq)), int32."""
        semantic = self.quantizer.tokenize(self.encoder(feat))
        return semantic, self.speaker_encoder.tokenize(self.mel(ref_wav))

    def detokenize(self, semantic_tokens, global_tokens):
        """semantic (B, T), global (B, token_num, nq) -> wav (B, T * hop)."""
        z_q = self.quantizer.detokenize(semantic_tokens)
        d_vector = self.speaker_encoder.detokenize(global_tokens)
        x = self.prenet(z_q, d_vector)
        x = x + d_vector[:, None, :]
        return self.decoder(x)[..., 0]
