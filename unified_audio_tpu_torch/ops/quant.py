"""Quantizer decode paths used by BiCodec's detokenize.

Port of the decode halves of ``unified_audio_tpu/ops/quant.py``:
``FactorizedVectorQuantize.detokenize`` (codebook lookup plus the 1x1
``out_project``), ``FSQ.indices_to_codes`` and
``ResidualFSQ.get_output_from_indices``. The encode and training halves are
not on the serving path. Parameter names follow the reference layout
(``codebook.weight``, ``out_project.weight``, ``project_out.weight``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..nn.conv import Conv1d


class FactorizedVectorQuantize(nn.Module):
    """Low-dim codebook + 1x1 out projection (decode only)."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        if input_dim == codebook_dim:
            raise NotImplementedError("the identity-projection variant is "
                                      "not ported")
        self.codebook = nn.Embedding(codebook_size, codebook_dim)
        self.out_project = Conv1d(codebook_dim, input_dim, 1, padding=0)

    def detokenize(self, indices):
        """indices (B, T) -> (B, T, input_dim)."""
        return self.out_project(self.codebook(indices.long()))


class FSQ:
    """Finite scalar quantization codes (stateless)."""

    def __init__(self, levels: Sequence[int]):
        self.levels = tuple(levels)

    def indices_to_codes(self, indices):
        """indices (...) int -> codes (..., len(levels)) in [-1, 1]."""
        dev = indices.device
        levels = torch.tensor(self.levels, dtype=torch.float32, device=dev)
        basis = torch.tensor(np.concatenate(
            [[1], np.cumprod(self.levels[:-1])]).astype(np.float32),
            device=dev)
        half = torch.tensor([l // 2 for l in self.levels],
                            dtype=torch.float32, device=dev)
        codes = torch.remainder(
            torch.floor_divide(indices[..., None].float(), basis), levels)
        return (codes - half) / half


class ResidualFSQ(nn.Module):
    """Residual FSQ decode: sum of per-layer codes times the layer scales,
    then ``project_out`` (codebook_dim -> dim)."""

    def __init__(self, levels: Sequence[int], num_quantizers: int, dim: int):
        super().__init__()
        self.fsq = FSQ(levels)
        self.num_quantizers = num_quantizers
        if dim == len(levels):
            raise NotImplementedError("the identity-projection variant is "
                                      "not ported")
        self.project_out = nn.Linear(len(levels), dim)
        lv = np.asarray(levels, dtype=np.float32)
        self.register_buffer("scales", torch.tensor(np.stack(
            [(lv - 1.0) ** -float(i) for i in range(num_quantizers)])),
            persistent=False)

    def get_output_from_indices(self, indices):
        """indices (B, T, nq) -> (B, T, dim)."""
        total = 0.0
        for i in range(self.num_quantizers):
            total = total + self.fsq.indices_to_codes(indices[..., i]) \
                * self.scales[i]
        return self.project_out(total)
