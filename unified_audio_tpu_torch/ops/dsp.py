"""Signal ops of the HCodec decode side: the periodic Hann window,
overlap-add and the "same"-padded ISTFT.

Port of ``hann_window``, ``overlap_add`` and ``istft_same`` in
``unified_audio_tpu/ops/dsp.py``, in fp32 with the same arithmetic order
(overlap-add as r = L / hop shifted adds, in the JAX package's order). The
STFT, the mel filterbanks and ``resample`` serve tokenize sides that the
port does not run yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, fp32: 0.5 - 0.5 cos(2 pi n / N)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Frames (..., T, L) at stride ``hop_length`` -> (..., (T - 1) * hop +
    L); ``hop_length`` must divide L."""
    *batch, t, length = frames.shape
    if length % hop_length:
        raise ValueError(f"hop {hop_length} does not divide frame {length}")
    r = length // hop_length
    chunks = frames.reshape(*batch, t, r, hop_length)
    acc = frames.new_zeros(*batch, t + r - 1, hop_length)
    for j in range(r):
        acc[..., j:j + t, :] += chunks[..., j, :]
    return acc.reshape(*batch, (t + r - 1) * hop_length)


def istft_same(spec: torch.Tensor, n_fft: int, hop_length: int,
               win_length: Optional[int] = None, eps: float = 1e-11):
    """ISTFT with "same" padding: windowed irfft frames overlap-added and
    divided by the overlap-added squared window (floored at ``eps``), with
    (win - hop) // 2 samples trimmed from both ends.

    spec: complex (B, N, T), N = n_fft // 2 + 1 -> (B, T * hop)."""
    win_length = win_length or n_fft
    window = hann_window(win_length, spec.device)
    pad = (win_length - hop_length) // 2
    frames = torch.fft.irfft(spec, n=n_fft, dim=-2)  # (B, n_fft, T)
    frames = (frames * window[None, :, None]).transpose(-1, -2)
    y = overlap_add(frames, hop_length)
    t = spec.shape[-1]
    envelope = overlap_add((window * window)[None, :].expand(t, win_length),
                           hop_length)
    return y[..., pad:-pad] / envelope[pad:-pad].clamp(min=eps)
