"""AdaptiveHCodecTokenizer: HCodec-1.5's tokenize/detokenize over XLSR-53.

Port of ``unified_audio_tpu/models/hcodec/adaptive_tokenizer.py``: the 16
kHz input is zero-padded on the right to a multiple of the hop (640); the
features are the mean of XLSR-53's hidden states 11, 14 and 16 of the wav
padded by (160, 160), compressed as sign(x) |x| ** 0.3; codes cross the API
as (B, nq, G) with the group lengths injected, so ``detokenize`` needs no
side channel. ``tokenize`` also returns the realised token rate, the
groups a second of each item, counted from the codes of the same encode
(the JAX package runs the aggregation a second time for it).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.nn import functional as F

from ..ssl.wav2vec2 import Wav2Vec2Model, xlsr_features
from .adaptive import AdaptiveHCodec


class AdaptiveHCodecTokenizer:
    def __init__(self, codec: AdaptiveHCodec, ssl: Wav2Vec2Model):
        self.codec, self.ssl = codec.eval(), ssl.eval()
        self.config = codec.config
        self.hop_length = self.config.base.hop_length

    def pad_wav(self, wav):
        """(B, T) -> (B, T') zero-padded on the right to a hop multiple."""
        return F.pad(wav, (0, -wav.shape[-1] % self.hop_length))

    @torch.no_grad()
    def extract_features(self, wav):
        """(B, T) 16 kHz -> (B, T / 320, 1024) compressed XLSR features."""
        mix = xlsr_features(self.ssl(F.pad(wav, (160, 160))))
        return torch.where(mix > 0, 1.0, -1.0) * mix.abs() ** 0.3

    @torch.no_grad()
    def tokenize(self, wav, threshold=None,
                 generator=None) -> Dict[str, torch.Tensor]:
        """(B, T) -> {"acoustic_codes", "semantic_codes": (B, nq, G)
        length-injected, "token_rate_hz": (B,) groups a second}."""
        wav = self.pad_wav(wav)
        acoustic, semantic = self.codec.encode(
            wav[..., None], self.extract_features(wav), threshold, generator)
        seconds = wav.shape[-1] / self.config.base.sample_rate
        return {
            "acoustic_codes": acoustic.transpose(-1, -2),
            "semantic_codes": semantic.transpose(-1, -2),
            "token_rate_hz": (acoustic[..., 0] >= 0).sum(-1).float()
            / seconds,
        }

    @torch.no_grad()
    def detokenize(self, acoustic_codes, semantic_codes):
        """(B, nq, G) codes -> waveform (B, G * hop)."""
        return self.codec.decode(acoustic_codes.transpose(-1, -2),
                                 semantic_codes.transpose(-1, -2))
