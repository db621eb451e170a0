"""HCodecTokenizer: the tokenize/detokenize API over the HuBERT frontend and
HCodec-1.0 or 2.0.

Port of ``unified_audio_tpu/models/hcodec/tokenizer.py``: the input, at the
codec's rate (16 or 48 kHz), is zero-padded to a multiple of the hop (640
or 3840), HuBERT runs on its 16 kHz version (resampled on the device for a
48 kHz codec) padded by (160, 160), and codes cross the API as (B, nq, T').

``dtype=torch.bfloat16`` is the bf16 serving mode: the codec's and HuBERT's
floating parameters and buffers are cast (``utils/precision.py``), the wav
and the features enter in bf16, and the fp32 islands stay fp32: the
nearest-code search (K6 on fp32 copies of the bf16 latents and codebooks,
``ops/quant.py``), softmax and norm statistics, HCodec-2.0's STFT
(``models/hcodec/codec.py``) and the ISTFT head (``nn/heads.py``).
``detokenize`` returns fp32 in either mode.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.dsp import resample
from ...utils.precision import cast_floating
from ..ssl.wav2vec2 import Wav2Vec2Model, hubert_features
from .codec import HCodec

SSL_RATE = 16000  # HuBERT's input rate


class HCodecTokenizer:
    def __init__(self, codec: HCodec, ssl: Wav2Vec2Model, dtype=None):
        """``dtype`` None keeps the modules as they are (fp32); a dtype
        casts both in place."""
        if dtype is not None:
            cast_floating(codec, dtype)
            cast_floating(ssl, dtype)
        self.codec, self.ssl = codec.eval(), ssl.eval()
        self.dtype = next(codec.parameters()).dtype
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
        """(B, T) at the codec's rate -> (B, T16 / 320, 768) HuBERT features
        of its 16 kHz version (T16 samples)."""
        wav = resample(wav, self.config.sample_rate, SSL_RATE)
        return hubert_features(self.ssl(F.pad(wav.to(self.dtype),
                                              (160, 160))))

    @torch.no_grad()
    def latents(self, wav):
        """(B, T) -> the codec's (acoustic, semantic) latents before VQ."""
        wav = self.pad_wav(wav)
        return self.codec.encode_latents(
            wav.to(self.dtype)[..., None],
            self.extract_features(wav).to(self.dtype))

    @torch.no_grad()
    def tokenize(self, wav):
        """(B, T) -> (acoustic, semantic) codes, each (B, nq, T')."""
        wav = self.pad_wav(wav)
        acoustic, semantic = self.codec.encode(
            wav.to(self.dtype)[..., None],
            self.extract_features(wav).to(self.dtype))
        return acoustic.transpose(-1, -2), semantic.transpose(-1, -2)

    @torch.no_grad()
    def detokenize(self, acoustic_codes, semantic_codes):
        """(B, nq, T') codes -> waveform (B, T' * hop), fp32."""
        return self.codec.decode(acoustic_codes.transpose(-1, -2),
                                 semantic_codes.transpose(-1, -2)).float()
