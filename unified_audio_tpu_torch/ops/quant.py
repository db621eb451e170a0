"""Quantizers at inference: BiCodec's decode paths and HCodec's residual VQ.

Port of parts of ``unified_audio_tpu/ops/quant.py``:
``FactorizedVectorQuantize.detokenize`` (codebook lookup plus the 1x1
``out_project``), ``FSQ.indices_to_codes``,
``ResidualFSQ.get_output_from_indices``, ``nearest_code``, and the encode and
decode of ``VectorQuantization`` and ``ResidualVQ``. On a CUDA tensor the
nearest-code search runs the hand-written kernels of ``ops/cuda/vq.py``
(K5 for one codebook, K6 for all residual layers in one launch); on the CPU
their plain versions. The EMA codebook updates, k-means and quantizer
dropout serve training and are not ported. Parameter names follow the
reference layouts (``codebook.weight``, ``out_project.weight``,
``project_out.weight``, ``layers.{i}._codebook.embed`` of shape (1, N, D)).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..nn.conv import Conv1d
from .cuda import vq


def nearest_code(x, codebook):
    """argmin_j |x_i - e_j|^2 for x (..., D), codebook (N, D) -> (...,)
    int32, ties to the lowest j, fp32."""
    flat = x.reshape(-1, x.shape[-1]).float().contiguous()
    return vq.nearest_code(flat, codebook.contiguous()).reshape(x.shape[:-1])


class _Codebook(nn.Module):
    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self.register_buffer("embed", torch.zeros(1, codebook_size, dim))


class VectorQuantization(nn.Module):
    """One Euclidean codebook (N, D), kept as the reference stores it."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self._codebook = _Codebook(codebook_size, dim)

    @property
    def embed(self):
        return self._codebook.embed[0]

    def encode(self, x):
        """(..., D) -> codes (...,) int32 (K5 on a CUDA tensor)."""
        return nearest_code(x, self.embed)

    def decode(self, indices):
        """codes (...) -> (..., D), an exact row gather."""
        return self.embed[indices.long()]


class ResidualVQ(nn.Module):
    """Residual VQ stack at inference: ``encode`` (B, T, D) -> codes
    (B, T, nq), ``decode`` codes -> (B, T, D)."""

    def __init__(self, dim: int, codebook_size: int, num_quantizers: int):
        super().__init__()
        self.layers = nn.ModuleList([
            VectorQuantization(dim, codebook_size)
            for _ in range(num_quantizers)])

    def codebooks(self):
        """The layers' (N, D) codebooks, views of their buffers (no copy)."""
        return tuple(layer.embed for layer in self.layers)

    def encode(self, x):
        """All layers in one K6 launch on a CUDA tensor: each layer codes
        the residual left by the ones before it. The kernel reads each
        layer's buffer where it lies, so a ``load_state_dict`` shows in the
        next call."""
        flat = x.reshape(-1, x.shape[-1]).float().contiguous()
        codes = vq.rvq_encode_fused(flat, self.codebooks())
        return codes.reshape(*x.shape[:-1], len(self.layers))

    def decode(self, codes):
        """codes (..., nq) -> (..., D); a code of -1 (quantizer dropout)
        contributes zero."""
        out = 0.0
        for i, layer in enumerate(self.layers):
            idx = codes[..., i]
            q = layer.decode(idx.clamp(min=0))
            out = out + q * (idx >= 0)[..., None]
        return out


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
