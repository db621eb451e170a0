"""Plain reference of the ``hcodec10`` configuration: HCodec-1.0 (SEANet
encoder, semantic encoder, two residual VQs searched plainly in fp32,
the ConvNeXt/ISTFT decoder) over the HuBERT-base frontend (the 16 kHz wav
padded by 160 samples a side, the mean of every layer's output under a
signed |x|^0.3), from the frozen plain copies in ``frozen/``: the round
trip ``HCodecTokenizer`` makes, with no kernel. fp32 with TF32 off unless
the caller turns TF32 on (the control)."""
from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from .frozen.codec import HCodec, HCodecConfig
from .frozen.wav2vec2 import SSLConfig, Wav2Vec2Model, hubert_features
from .unise import _tuples


class HCodec10Reference(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.codec = HCodec(HCodecConfig(**_tuples(cfg["hcodec"])))
        self.ssl = Wav2Vec2Model(SSLConfig(**_tuples(cfg["hubert"])))
        self.hop = cfg["hcodec"]["hop_length"]

    def pad(self, wav):
        return F.pad(wav, (0, -wav.shape[-1] % self.hop))

    def features(self, wav):
        """(B, T) at 16 kHz -> (B, T / 320, 768) HuBERT features."""
        return hubert_features(self.ssl(F.pad(wav, (160, 160))))

    def tokenize(self, wav):
        """(B, T) -> (acoustic, semantic) codes, each (B, nq, T')."""
        wav = self.pad(wav)
        a, s = self.codec.encode(wav[..., None], self.features(wav))
        return a.transpose(-1, -2), s.transpose(-1, -2)

    def detokenize(self, acoustic, semantic):
        """(B, nq, T') codes -> (B, T' * hop) waveforms."""
        return self.codec.decode(acoustic.transpose(-1, -2),
                                 semantic.transpose(-1, -2))
