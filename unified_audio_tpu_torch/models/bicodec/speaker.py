"""Speaker (global-token) branch of BiCodec, decode side only.

Port of ``SpeakerEncoder.detokenize`` in
``unified_audio_tpu/models/bicodec/speaker.py``: the Residual-FSQ decode of
the global tokens and the d-vector projection. The ECAPA-TDNN and Perceiver
that make the tokens belong to tokenize and are not built.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.quant import ResidualFSQ


class SpeakerEncoder(nn.Module):
    def __init__(self, out_dim: int = 1024, latent_dim: int = 128,
                 token_num: int = 32,
                 fsq_levels: Sequence[int] = (4, 4, 4, 4, 4, 4),
                 fsq_num_quantizers: int = 1):
        super().__init__()
        self.quantizer = ResidualFSQ(fsq_levels, fsq_num_quantizers,
                                     latent_dim)
        self.project = nn.Linear(latent_dim * token_num, out_dim)

    @staticmethod
    def _flatten_cf(zq):
        """(B, T, D) -> (B, D*T), flattened channel-major like the
        reference's channel-first tensor (the project weights are laid out
        d-major)."""
        return zq.transpose(1, 2).reshape(zq.shape[0], -1)

    def detokenize(self, indices):
        """Global tokens (B, token_num, nq) -> d-vector (B, out_dim)."""
        zq = self.quantizer.get_output_from_indices(indices)
        return self.project(self._flatten_cf(zq))
