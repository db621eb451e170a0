"""HCodecTokenizer: the tokenize/detokenize API over the HuBERT frontend and
HCodec-1.0.

Port of ``unified_audio_tpu/models/hcodec/tokenizer.py`` for 16 kHz audio in
fp32: the input is zero-padded to a multiple of the hop, the HuBERT features
come from that input padded by (160, 160), and codes cross the API as
(B, nq, T'). Resampling (HCodec-2.0's 48 kHz) and the bf16 serving mode are
not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ssl.wav2vec2 import Wav2Vec2Model, hubert_features
from .codec import HCodec


class HCodecTokenizer:
    def __init__(self, codec: HCodec, ssl: Wav2Vec2Model):
        if codec.config.sample_rate != 16000:
            raise NotImplementedError("resampling is not ported yet: the "
                                      "port's HCodec runs 16 kHz models")
        self.codec, self.ssl = codec.eval(), ssl.eval()
        self.config = codec.config
        self.hop_length = self.config.hop_length
        for m in codec.modules():
            if isinstance(m, nn.LSTM):
                m.flatten_parameters()  # one weight buffer for cuDNN

    def pad_wav(self, wav):
        """(B, T) -> (B, T') zero-padded on the right to a hop multiple."""
        pad = -wav.shape[-1] % self.hop_length
        return F.pad(wav, (0, pad))

    @torch.no_grad()
    def extract_features(self, wav):
        """(B, T) -> (B, T / 320, 768) HuBERT features."""
        return hubert_features(self.ssl(F.pad(wav, (160, 160))))

    @torch.no_grad()
    def latents(self, wav):
        """(B, T) -> the codec's (acoustic, semantic) latents before VQ."""
        wav = self.pad_wav(wav)
        return self.codec.encode_latents(wav[..., None],
                                         self.extract_features(wav))

    @torch.no_grad()
    def tokenize(self, wav):
        """(B, T) -> (acoustic, semantic) codes, each (B, nq, T')."""
        wav = self.pad_wav(wav)
        acoustic, semantic = self.codec.encode(wav[..., None],
                                               self.extract_features(wav))
        return acoustic.transpose(-1, -2), semantic.transpose(-1, -2)

    @torch.no_grad()
    def detokenize(self, acoustic_codes, semantic_codes):
        """(B, nq, T') codes -> waveform (B, T' * hop), fp32."""
        return self.codec.decode(acoustic_codes.transpose(-1, -2),
                                 semantic_codes.transpose(-1, -2)).float()
