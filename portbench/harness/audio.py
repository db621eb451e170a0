"""Synthetic speech-like audio from a seed, made on the device in bulk: a
harmonic source with a moving pitch under syllable envelopes, over a
little noise, peak-normalized and put on the int16 grid (so a waveform
crosses any int16 wire unchanged)."""
from __future__ import annotations

import math


def synth(torch, generator, n_clips: int, n_samples: int, sr: int = 16000,
          device="cuda"):
    """-> (n_clips, n_samples) float32 on ``device``, every sample k/32768."""
    f = dict(generator=generator, device=device)
    t = torch.arange(n_samples, device=device, dtype=torch.float32) / sr
    f0 = 90.0 + 160.0 * torch.rand(n_clips, 1, **f)
    wobble = 0.1 * torch.sin(2 * math.pi * (0.5 + 2.0 * torch.rand(
        n_clips, 1, **f)) * t[None])
    phase = 2 * math.pi * torch.cumsum(f0 * (1 + wobble), dim=1) / sr
    src = sum(torch.sin(h * phase) / h for h in range(1, 9))
    # syllable envelopes at ~4 Hz: random levels, linearly interpolated
    n_syl = int(n_samples / sr * 4) + 2
    levels = torch.rand(n_clips, 1, n_syl, **f) ** 2
    env = torch.nn.functional.interpolate(levels, size=n_samples,
                                          mode="linear", align_corners=True)
    x = src * env[:, 0] + 0.05 * torch.randn(n_clips, n_samples, **f)
    x = x / x.abs().amax(dim=1, keepdim=True).clamp(min=1e-6) * 0.9
    return torch.round(x * 32768.0).clamp(-32768, 32767) / 32768.0
