"""MusicGen-style delay pattern over the K codebooks of a frame.

Port of ``unified_audio_tpu/models/unitok/delay.py``: codebook k is shifted
right by k steps, so at generation step t the model emits codebook k's code
of frame t - k, and every codebook decodes one step per frame.
"""
from __future__ import annotations

import torch


def apply_delay(codes: torch.Tensor, pad_token: int) -> torch.Tensor:
    """codes (B, T, K) -> delayed (B, T+K-1, K); codebook k shifted right by
    k, the holes filled with ``pad_token``."""
    b, t, k = codes.shape
    out = torch.full((b, t + k - 1, k), pad_token, dtype=codes.dtype,
                     device=codes.device)
    for layer in range(k):
        out[:, layer:layer + t, layer] = codes[..., layer]
    return out


def undo_delay(delayed: torch.Tensor) -> torch.Tensor:
    """delayed (B, T+K-1, K) -> codes (B, T, K)."""
    b, tk, k = delayed.shape
    t = tk - k + 1
    return torch.stack([delayed[:, layer:layer + t, layer]
                        for layer in range(k)], dim=-1)
