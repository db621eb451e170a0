"""BiCodecTokenizer: waveform -> (global, semantic) tokens and back.

Port of ``unified_audio_tpu/models/bicodec/tokenizer.py``:
``normalize_input`` (per-utterance zero mean and unit population variance,
eps 1e-7 inside the root), ``get_ref_clip`` (the 6-s reference clip, tiled
when the input is shorter), ``extract_features`` (the XLSR-53 layers
{11, 14, 16} / 3), ``tokenize`` and ``detokenize``. Serving builds the
decode side only; ``tokenize`` needs the XLSR model (``ssl``) and a
``BiCodec`` built with ``tokenize=True``. The tokenizer is frozen: it runs
without gradients and keeps its modules in ``.eval()``. With the recorder
of ``utils/profiling.py`` on, ``tokenize`` records ``bicodec.xlsr`` (the
features) and ``bicodec.tokenize`` (BiCodec's tokenize side).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...utils.profiling import span
from ..ssl.wav2vec2 import Wav2Vec2Model, xlsr_features
from .bicodec import BiCodec, BiCodecConfig


def normalize_input(wav: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) per sequence, population variance."""
    mean = wav.mean(dim=-1, keepdim=True)
    var = wav.var(dim=-1, keepdim=True, correction=0)
    return (wav - mean) / torch.sqrt(var + eps)


class BiCodecTokenizer:
    def __init__(self, model: BiCodec, ssl: Optional[Wav2Vec2Model] = None):
        self.model = model
        self.ssl = ssl
        self.config: BiCodecConfig = model.config

    def eval(self) -> "BiCodecTokenizer":
        """Frozen: ``.eval()`` (BatchNorm on its running statistics) and
        no gradients."""
        for m in (self.model, self.ssl):
            if m is not None:
                m.eval().requires_grad_(False)
        return self

    def get_ref_clip(self, wav: torch.Tensor) -> torch.Tensor:
        """The speaker branch's reference: the first ref_segment_duration
        seconds (hop-aligned), the input tiled first when it is shorter."""
        cfg = self.config
        ref_len = (int(cfg.sample_rate * cfg.ref_segment_duration)
                   // cfg.latent_hop_length * cfg.latent_hop_length)
        t = wav.shape[-1]
        if ref_len > t:
            wav = wav.repeat(1, ref_len // t + 1)
        return wav[:, :ref_len]

    @torch.no_grad()
    def extract_features(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> XLSR features (B, frames, 1024)."""
        return xlsr_features(self.ssl(normalize_input(wav)))

    @torch.no_grad()
    def tokenize(self, wav: torch.Tensor):
        """(B, T) -> (global (B, nq, token_num), semantic (B, frames)),
        int32, the reference's return layout."""
        if self.ssl is None or not isinstance(
                getattr(self.model, "encoder", None), nn.Module):
            raise RuntimeError("this tokenizer was built for decoding only "
                               "(no XLSR model or no BiCodec encoder)")
        with span("bicodec.xlsr"):
            feat = self.extract_features(wav)
        with span("bicodec.tokenize"):
            semantic, global_ = self.model.tokenize(feat,
                                                    self.get_ref_clip(wav))
        return global_.transpose(-1, -2), semantic

    @torch.no_grad()
    def detokenize(self, global_tokens, semantic_tokens):
        """global (B, nq, token_num), semantic (B, T) -> wav (B, T * hop)."""
        return self.model.detokenize(semantic_tokens,
                                     global_tokens.transpose(-1, -2))
