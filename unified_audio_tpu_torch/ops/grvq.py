"""AutoGroup (residual) vector quantization.

Port of ``unified_audio_tpu/ops/grvq.py`` (HCodec-2.0's auto_grvq, which
the reference defines and does not use). Two factorized cosine-nearest
codebooks (HiFi-Codec's grouped quantization) code the two halves of the
projection; their outputs concatenate back to the input width, and the
two codes fuse into one index ``a * codebook_size + b``. With
``frame_residual_vq`` each frame is coded as its difference from the
previous one (a diff along time before the search, a cumulative sum
after). :class:`AutoGroupResidualVectorQuantize` stacks N of them on the
residual, the temporal residual in the first only.

The 1x1 projections are plain convs (``in_proj_a`` ... ``out_proj_b``);
``utils/convert.py grvq_state_dict`` folds the JAX package's weight norm
into them. The losses are the JAX package's, per batch row, with the
straight-through estimator.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.conv import Conv1d
from .quant import cosine_nearest_code


def _mse(a, b):
    return (a - b).square().mean(dim=(1, 2))


class AutoGroupVectorQuantize(nn.Module):
    """z (B, T, input_dim) -> dict(z_q, commitment_loss, codebook_loss,
    indices (B, T) int32)."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 frame_residual_vq: bool = False):
        super().__init__()
        self.codebook_size = codebook_size
        self.frame_residual_vq = frame_residual_vq
        self.in_proj_a = Conv1d(input_dim, codebook_dim, 1, padding=0)
        self.in_proj_b = Conv1d(input_dim, codebook_dim, 1, padding=0)
        self.out_proj_a = Conv1d(codebook_dim, input_dim // 2, 1, padding=0)
        self.out_proj_b = Conv1d(codebook_dim, input_dim // 2, 1, padding=0)
        self.codebook_a = nn.Parameter(torch.randn(codebook_size,
                                                   codebook_dim))
        self.codebook_b = nn.Parameter(torch.randn(codebook_size,
                                                   codebook_dim))

    @staticmethod
    def _temporal_delta(z):
        """z[t] - z[t - 1] for t > 0; frame 0 kept."""
        return torch.cat([z[:, :1], z[:, 1:] - z[:, :-1]], dim=1)

    def _decode_groups(self, zq_a, zq_b):
        z_q = torch.cat([self.out_proj_a(zq_a), self.out_proj_b(zq_b)], -1)
        return z_q.cumsum(dim=1) if self.frame_residual_vq else z_q

    def forward(self, z):
        if self.frame_residual_vq:
            z = self._temporal_delta(z)
        z_a, z_b = self.in_proj_a(z), self.in_proj_b(z)
        idx_a = cosine_nearest_code(z_a, self.codebook_a)
        idx_b = cosine_nearest_code(z_b, self.codebook_b)
        zq_a = self.codebook_a[idx_a.long()]
        zq_b = self.codebook_b[idx_b.long()]
        commitment = _mse(z_a, zq_a.detach()) + _mse(z_b, zq_b.detach())
        codebook_loss = _mse(zq_a, z_a.detach()) + _mse(zq_b, z_b.detach())
        zq_a = z_a + (zq_a - z_a).detach()
        zq_b = z_b + (zq_b - z_b).detach()
        return {"z_q": self._decode_groups(zq_a, zq_b),
                "commitment_loss": commitment,
                "codebook_loss": codebook_loss,
                "indices": idx_a * self.codebook_size + idx_b}

    def decode_indices(self, indices):
        """indices (B, T) -> z_q (B, T, input_dim)."""
        indices = indices.long()
        return self._decode_groups(
            self.codebook_a[indices // self.codebook_size],
            self.codebook_b[indices % self.codebook_size])


class AutoGroupResidualVectorQuantize(nn.Module):
    """``num_quantizers`` AutoGroup quantizers on the residual; indices
    (B, T, nq)."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 num_quantizers: int = 2, frame_residual_vq: bool = False):
        super().__init__()
        self.quantizers = nn.ModuleList([
            AutoGroupVectorQuantize(input_dim, codebook_size, codebook_dim,
                                    frame_residual_vq and i == 0)
            for i in range(num_quantizers)])

    def forward(self, z):
        residual, z_q = z, torch.zeros_like(z)
        commitment = codebook = 0.0
        indices = []
        for q in self.quantizers:
            out = q(residual)
            residual = residual - out["z_q"].detach()
            z_q = z_q + out["z_q"]
            commitment = commitment + out["commitment_loss"]
            codebook = codebook + out["codebook_loss"]
            indices.append(out["indices"])
        return {"z_q": z_q, "commitment_loss": commitment,
                "codebook_loss": codebook,
                "indices": torch.stack(indices, dim=-1)}

    def decode_indices(self, indices):
        out = 0.0
        for i, q in enumerate(self.quantizers):
            out = out + q.decode_indices(indices[..., i])
        return out
