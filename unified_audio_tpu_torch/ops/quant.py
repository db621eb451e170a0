"""Quantizers: BiCodec's tokenize and decode paths, HCodec's residual VQ
at inference and in training.

Port of parts of ``unified_audio_tpu/ops/quant.py``: ``cosine_nearest_code``,
``FactorizedVectorQuantize.tokenize`` (the 1x1 ``in_project`` and the cosine
search) and ``detokenize`` (codebook lookup plus the 1x1 ``out_project``),
``FSQ`` (``bound``, ``quantize``, ``codes_to_indices``,
``indices_to_codes``), ``ResidualFSQ`` (the residual quantization into
indices and ``get_output_from_indices``), ``nearest_code``,
``sample_vectors``, ``kmeans``, and ``VectorQuantization`` and
``ResidualVQ``: encode and decode, and the training forward (k-means
initialization on the first batch, the EMA codebook update with Laplace
smoothing, the commitment loss, the straight-through output, structured
quantizer dropout). On a CUDA tensor every nearest-code search, those of
the training forward and of k-means included, runs the hand-written
kernels of ``ops/cuda/vq.py`` (K5 for one codebook, K6 for all residual
layers in one launch); on the CPU their plain versions. BiCodec's
quantizers are frozen: the cosine search and FSQ run plain, as in the JAX
package.

Random draws (k-means' initial rows, the dropout cutoff) each come from
one small function (:func:`sample_rows`, :func:`dropout_cutoff`) of an
explicit ``torch.Generator``. The JAX package's dead-code expiry is left
out: it writes replacement rows into the codebook that the EMA update
overwrites a few lines later (as in the upstream EnCodec ``core_vq``), so
the codebook comes out the same without it.

Parameter names follow the reference layouts (``codebook.weight``,
``in_project.weight``, ``out_project.weight``, ``project_in.weight``,
``project_out.weight``, ``layers.{i}._codebook.embed`` of shape (1, N, D);
for training also ``_codebook.embed_avg`` (1, N, D), ``cluster_size`` (1,
N) and ``initted`` (1,)).
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
    flat = x.detach().reshape(-1, x.shape[-1]).float().contiguous()
    return vq.nearest_code(flat, codebook.contiguous()).reshape(x.shape[:-1])


def cosine_nearest_code(x, codebook):
    """argmax_j of the cosine similarity of x (..., D) and codebook (N, D),
    both sides L2-normalized (norms floored at 1e-12) -> (...,) int32,
    ties to the lowest j."""
    xn = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    cn = codebook / codebook.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.argmax(torch.einsum("...d,nd->...n", xn, cn), dim=-1).int()


def sample_rows(m: int, num: int, generator=None):
    """Indices (num,) int64 of rows among M, on the generator's device:
    the first ``num`` of a random permutation when M >= num, else ``num``
    uniform draws with replacement (``sample_vectors``' draw)."""
    if m >= num:
        return torch.randperm(m, generator=generator)[:num]
    return torch.randint(0, m, (num,), generator=generator)


def dropout_cutoff(nq: int, generator=None) -> int:
    """The last residual layer kept by quantizer dropout, uniform in
    [0, nq)."""
    return int(torch.randint(0, nq, (), generator=generator))


def sample_vectors(samples, num: int, generator=None):
    """``num`` rows of ``samples`` (M, D) (:func:`sample_rows`)."""
    idx = sample_rows(samples.shape[0], num, generator)
    return samples[idx.to(samples.device)]


def _bins_and_sums(samples, codes, num_clusters: int):
    """Per cluster the rows it takes (fp32) and their sum (N, D)."""
    codes = codes.long()
    bins = torch.bincount(codes, minlength=num_clusters).to(samples.dtype)
    sums = samples.new_zeros(num_clusters, samples.shape[1]).index_add_(
        0, codes, samples)
    return bins, sums


@torch.no_grad()
def kmeans(samples, num_clusters: int, num_iters: int = 10, generator=None):
    """Lloyd's k-means of ``samples`` (M, D) from :func:`sample_vectors`'
    rows -> (means (N, D), bins (N,) fp32). An empty cluster keeps its
    mean. Each iteration's search and the final bins' go through
    :func:`nearest_code` (K5 on a CUDA tensor)."""
    means = sample_vectors(samples, num_clusters, generator)
    for _ in range(num_iters):
        bins, sums = _bins_and_sums(
            samples, nearest_code(samples, means), num_clusters)
        new = sums / bins.clamp(min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new)
    bins, _ = _bins_and_sums(samples, nearest_code(samples, means),
                             num_clusters)
    return means, bins


class _Codebook(nn.Module):
    """The codebook's buffers; with ``ema`` also the EMA statistics and the
    k-means flag, which the host tracks once it has read it."""

    def __init__(self, codebook_size: int, dim: int, ema: bool = False):
        super().__init__()
        self.register_buffer("embed", torch.zeros(1, codebook_size, dim))
        if ema:
            self.register_buffer("embed_avg",
                                 torch.zeros(1, codebook_size, dim))
            self.register_buffer("cluster_size",
                                 torch.zeros(1, codebook_size))
            self.register_buffer("initted", torch.zeros(1))
        self._initted = None  # the host's copy of ``initted``

    def is_initted(self) -> bool:
        if self._initted is None:
            self._initted = bool(self.initted.item())
        return self._initted

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._initted = None


EMA_DECAY = 0.99  # the JAX package's VectorQuantization defaults
LAPLACE_EPSILON = 1e-5
KMEANS_ITERS = 50


class VectorQuantization(nn.Module):
    """One Euclidean codebook (N, D), kept as the reference stores it.
    ``ema`` builds the training state."""

    def __init__(self, dim: int, codebook_size: int, ema: bool = False):
        super().__init__()
        self._codebook = _Codebook(codebook_size, dim, ema)
        self.kmeans_iters = KMEANS_ITERS

    @property
    def embed(self):
        return self._codebook.embed[0]

    def encode(self, x):
        """(..., D) -> codes (...,) int32 (K5 on a CUDA tensor)."""
        return nearest_code(x, self.embed)

    def decode(self, indices):
        """codes (...) -> (..., D), an exact row gather."""
        return self.embed[indices.long()]

    def forward(self, x, train: bool = False, generator=None):
        """x (..., D) -> (quantized, codes (...) int32, loss ()).

        In training: k-means' means on the first batch (``generator``
        draws its rows), the search in the codebook as it was before this
        batch, the EMA update of the buffers from this batch's codes
        (decay 0.99, Laplace smoothing 1e-5), the commitment loss
        ``mean((sg(q) - x)^2)`` (weight 1) and the straight-through output
        ``x + sg(q - x)``."""
        if not train:
            idx = self.encode(x)
            return self.decode(idx), idx, x.new_zeros(())
        cb, n_codes = self._codebook, self.embed.shape[0]
        flat = x.detach().reshape(-1, x.shape[-1])
        with torch.no_grad():
            if not cb.is_initted():
                means, bins = kmeans(flat, n_codes, self.kmeans_iters,
                                     generator)
                cb.embed[0] = means
                cb.embed_avg[0] = means
                cb.cluster_size[0] = bins
            idx = nearest_code(flat, self.embed)
            quantized = self.decode(idx)
            counts, embed_sum = _bins_and_sums(flat, idx, n_codes)
            d, eps = EMA_DECAY, LAPLACE_EPSILON
            size = cb.cluster_size[0] * d + counts * (1 - d)
            avg = cb.embed_avg[0] * d + embed_sum * (1 - d)
            total = size.sum()
            smoothed = (size + eps) / (total + n_codes * eps) * total
            cb.embed[0] = avg / smoothed[:, None]
            cb.embed_avg[0] = avg
            cb.cluster_size[0] = size
            cb.initted.fill_(1.0)
            cb._initted = True
        quantized = quantized.view(x.shape)
        loss = (quantized - x).square().mean()
        return (x + (quantized - x).detach(), idx.view(x.shape[:-1]), loss)


class ResidualVQ(nn.Module):
    """Residual VQ stack: ``encode`` (B, T, D) -> codes (B, T, nq),
    ``decode`` codes -> (B, T, D); with ``ema`` also the training
    ``forward``, with structured quantizer dropout if
    ``quantize_dropout``."""

    def __init__(self, dim: int, codebook_size: int, num_quantizers: int,
                 ema: bool = False, quantize_dropout: bool = False):
        super().__init__()
        self.quantize_dropout = quantize_dropout
        self.layers = nn.ModuleList([
            VectorQuantization(dim, codebook_size, ema=ema)
            for _ in range(num_quantizers)])

    def forward(self, x, train: bool = False, generator=None):
        """x (B, T, D) -> (quantized (B, T, D), codes (B, T, nq), losses
        (nq,)). Each layer quantizes the residual the layers before it
        leave. In training with quantizer dropout one cutoff is drawn a
        batch (:func:`dropout_cutoff`); the layers past it still search and
        update their codebooks but give zeros, codes -1 and a zero loss."""
        nq = len(self.layers)
        cutoff = (dropout_cutoff(nq, generator)
                  if train and self.quantize_dropout and nq > 1 else nq - 1)
        out, residual, codes, losses = 0.0, x, [], []
        for i, layer in enumerate(self.layers):
            q, idx, loss = layer(residual, train=train, generator=generator)
            if i > cutoff:
                q, idx = torch.zeros_like(q), torch.full_like(idx, -1)
                loss = torch.zeros_like(loss)
            residual = residual - q.detach()
            out = out + q
            codes.append(idx)
            losses.append(loss)
        return out, torch.stack(codes, -1), torch.stack(losses)

    def codebooks(self):
        """The layers' (N, D) codebooks, views of their buffers (no copy)."""
        return tuple(layer.embed for layer in self.layers)

    def fp32_codebooks(self):
        """The codebooks as K5/K6 take them, fp32: the buffers themselves in
        fp32, fp32 copies of them made each call in the bf16 serving
        mode."""
        return tuple(cb.float() for cb in self.codebooks())

    def encode(self, x):
        """All layers in one K6 launch on a CUDA tensor: each layer codes
        the residual left by the ones before it, in fp32 whatever the
        model's dtype (bf16 latents and codebooks enter as their exact fp32
        values; the residual stays fp32 between the layers, where the JAX
        package rounds it to bf16). The kernel reads each fp32 layer's
        buffer where it lies, so a ``load_state_dict`` shows in the next
        call."""
        flat = x.reshape(-1, x.shape[-1]).float().contiguous()
        codes = vq.rvq_encode_fused(flat, self.fp32_codebooks())
        return codes.reshape(*x.shape[:-1], len(self.layers))

    def decode(self, codes):
        """codes (..., nq) -> (..., D) in the codebooks' dtype (summed in
        bf16 in the bf16 mode, as in the JAX package); a code of -1
        (quantizer dropout) contributes zero."""
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
