"""BiCodecTokenizer, decode side: (global, semantic) tokens -> waveform.

Port of ``BiCodecTokenizer.detokenize`` in
``unified_audio_tpu/models/bicodec/tokenizer.py``. The XLSR-53 SSL model
and the feature encoder serve tokenize only and are not built.
"""
from __future__ import annotations

import torch

from .bicodec import BiCodec, BiCodecConfig


class BiCodecTokenizer:
    def __init__(self, model: BiCodec):
        self.model = model
        self.config: BiCodecConfig = model.config

    @torch.no_grad()
    def detokenize(self, global_tokens, semantic_tokens):
        """global (B, nq, token_num), semantic (B, T) -> wav (B, T * hop)."""
        return self.model.detokenize(semantic_tokens,
                                     global_tokens.transpose(-1, -2))
