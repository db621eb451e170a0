"""Quantizers at inference: BiCodec's tokenize and decode paths and HCodec's
residual VQ.

Port of parts of ``unified_audio_tpu/ops/quant.py``: ``cosine_nearest_code``,
``FactorizedVectorQuantize.tokenize`` (the 1x1 ``in_project`` and the cosine
search) and ``detokenize`` (codebook lookup plus the 1x1 ``out_project``),
``FSQ`` (``bound``, ``quantize``, ``codes_to_indices``,
``indices_to_codes``), ``ResidualFSQ`` (the residual quantization into
indices and ``get_output_from_indices``), ``nearest_code``, and the encode
and decode of ``VectorQuantization`` and ``ResidualVQ``. On a CUDA tensor the
nearest-code search runs the hand-written kernels of ``ops/cuda/vq.py``
(K5 for one codebook, K6 for all residual layers in one launch); on the CPU
their plain versions. BiCodec's quantizers are frozen: the cosine search
and FSQ run plain, as in the JAX package. The EMA codebook updates, k-means
and quantizer dropout serve codec training and are not ported. Parameter
names follow the reference layouts (``codebook.weight``,
``in_project.weight``, ``out_project.weight``, ``project_in.weight``,
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


def cosine_nearest_code(x, codebook):
    """argmax_j of the cosine similarity of x (..., D) and codebook (N, D),
    both sides L2-normalized (norms floored at 1e-12) -> (...,) int32,
    ties to the lowest j."""
    xn = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    cn = codebook / codebook.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.argmax(torch.einsum("...d,nd->...n", xn, cn), dim=-1).int()


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
    """Low-dim codebook with 1x1 projections: ``out_project`` decodes, and
    with ``tokenize`` the module also builds ``in_project`` and the cosine
    search."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 tokenize: bool = False):
        super().__init__()
        if input_dim == codebook_dim:
            raise NotImplementedError("the identity-projection variant is "
                                      "not ported")
        self.codebook = nn.Embedding(codebook_size, codebook_dim)
        self.out_project = Conv1d(codebook_dim, input_dim, 1, padding=0)
        if tokenize:
            self.in_project = Conv1d(input_dim, codebook_dim, 1, padding=0)

    def tokenize(self, z):
        """z (B, T, input_dim) -> indices (B, T) int32."""
        return cosine_nearest_code(self.in_project(z), self.codebook.weight)

    def detokenize(self, indices):
        """indices (B, T) -> (B, T, input_dim)."""
        return self.out_project(self.codebook(indices.long()))


class FSQ:
    """Finite scalar quantization (stateless), fp32."""

    def __init__(self, levels: Sequence[int]):
        self.levels = tuple(levels)

    def _consts(self, dev):
        """(levels, basis, half widths), each (len(levels),) fp32."""
        levels = torch.tensor(self.levels, dtype=torch.float32, device=dev)
        basis = torch.tensor(np.concatenate(
            [[1], np.cumprod(self.levels[:-1])]).astype(np.float32),
            device=dev)
        half = torch.tensor([l // 2 for l in self.levels],
                            dtype=torch.float32, device=dev)
        return levels, basis, half

    def bound(self, z, eps: float = 1e-3):
        """tanh(z + atanh(offset / half_l)) * half_l - offset, half_l =
        (levels - 1)(1 + eps) / 2, offset 0.5 for even levels."""
        levels, _, _ = self._consts(z.device)
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        return torch.tanh(z + torch.atanh(offset / half_l)) * half_l - offset

    def quantize(self, z):
        """z (..., len(levels)) -> codes in [-1, 1]: the bounded value
        rounded half to even, over the half width."""
        return torch.round(self.bound(z)) / self._consts(z.device)[2]

    def codes_to_indices(self, zhat):
        _, basis, half = self._consts(zhat.device)
        return ((zhat * half + half) * basis).sum(dim=-1).int()

    def indices_to_codes(self, indices):
        """indices (...) int -> codes (..., len(levels)) in [-1, 1]."""
        levels, basis, half = self._consts(indices.device)
        codes = torch.remainder(
            torch.floor_divide(indices[..., None].float(), basis), levels)
        return (codes - half) / half

    def __call__(self, z):
        """-> (codes, indices) of z (..., len(levels))."""
        codes = self.quantize(z.float()).to(z.dtype)
        return codes, self.codes_to_indices(codes)


class ResidualFSQ(nn.Module):
    """Residual FSQ. Decode: the sum of per-layer codes times the layer
    scales, then ``project_out`` (codebook_dim -> dim). With ``tokenize``
    the module also builds ``project_in`` (dim -> codebook_dim) and the
    residual quantization into indices."""

    def __init__(self, levels: Sequence[int], num_quantizers: int, dim: int,
                 tokenize: bool = False):
        super().__init__()
        self.fsq = FSQ(levels)
        self.num_quantizers = num_quantizers
        if dim == len(levels):
            raise NotImplementedError("the identity-projection variant is "
                                      "not ported")
        if tokenize:
            self.project_in = nn.Linear(dim, len(levels))
        self.project_out = nn.Linear(len(levels), dim)
        lv = np.asarray(levels, dtype=np.float32)
        self.register_buffer("scales", torch.tensor(np.stack(
            [(lv - 1.0) ** -float(i) for i in range(num_quantizers)])),
            persistent=False)

    def forward(self, x):
        """x (B, T, dim) -> indices (B, T, nq) int32: each layer quantizes
        the residual the layers before it leave, scaled by its scale."""
        residual = self.project_in(x)
        out = []
        for i in range(self.num_quantizers):
            q, idx = self.fsq(residual / self.scales[i])
            residual = residual - q * self.scales[i]
            out.append(idx)
        return torch.stack(out, dim=-1)

    def get_output_from_indices(self, indices):
        """indices (B, T, nq) -> (B, T, dim)."""
        total = 0.0
        for i in range(self.num_quantizers):
            total = total + self.fsq.indices_to_codes(indices[..., i]) \
                * self.scales[i]
        return self.project_out(total)
