"""The Kaldi-compatible fbank frontend of FlexiCodec's semantic teacher
(funasr ``WavFrontend``: kaldi fbank 80 x 25/10 ms, LFR 7/6, CMVN).

Port of ``unified_audio_tpu/ops/fbank.py``: ``kaldi_mel_banks``,
``kaldi_fbank``, ``apply_lfr``, ``load_kaldi_cmvn``, ``apply_cmvn`` and
``SenseVoiceFrontend``.

1. Kaldi fbank (snip_edges framing): the wav scaled to the int16 range,
   optional dither, per-frame DC removal, 0.97 pre-emphasis (the first
   sample subtracts itself), the symmetric Hamming window, zero-padded to
   the next power-of-two FFT (512), the power spectrum, Kaldi's triangular
   HTK-scale mel banks (20 Hz to Nyquist), ``log(max(., float32 eps))``.
2. LFR: ``(m-1)//2`` copies of the first frame on the left, windows of m
   frames at stride n (``ceil(T / n)`` of them), the tail padded with the
   last frame.
3. CMVN: ``(x + addshift) * rescale`` from the ``<AddShift>`` and
   ``<Rescale>`` rows of a Kaldi nnet text file (``am.mvn``).

Framing and LFR are index gathers, the FFT one batched rfft; the CMVN file
is parsed on the host.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Optional, Tuple

import numpy as np
import torch

_FLOAT32_EPS = float(np.finfo(np.float32).eps)  # kaldi's log floor


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def kaldi_mel_banks(num_bins: int, fft_size: int, sample_rate: float,
                    low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi's triangular mel filterbank, (num_bins, fft_size // 2 + 1)
    fp32; ``high_freq <= 0`` means Nyquist + high_freq; the Nyquist bin
    weighs 0."""
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"bad mel range [{low_freq}, {high_freq}]")
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bin_mels = _mel(sample_rate / fft_size * np.arange(fft_size // 2))
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    right = left + mel_delta + mel_delta
    up = (bin_mels[None, :] - left) / mel_delta
    down = (right - bin_mels[None, :]) / mel_delta
    weights = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return np.concatenate([weights, np.zeros((num_bins, 1), np.float32)],
                          axis=1)


def _hamming(window_size: int) -> np.ndarray:
    """Symmetric Hamming: 0.54 - 0.46 cos(2 pi i / (M - 1))."""
    i = np.arange(window_size, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * i / (window_size - 1))
            ).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _constants(window_size: int, fft_size: int, num_bins: int,
               sample_rate: float, low_freq: float, high_freq: float,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window (W,), mel banks (bins, F)) on ``device``, copied once."""
    return (torch.as_tensor(_hamming(window_size), device=device),
            torch.as_tensor(kaldi_mel_banks(num_bins, fft_size, sample_rate,
                                            low_freq, high_freq),
                            device=device))


def kaldi_fbank(wav, sample_rate: int = 16000, num_mel_bins: int = 80,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                dither: float = 0.0, preemphasis: float = 0.97,
                remove_dc_offset: bool = True, low_freq: float = 20.0,
                high_freq: float = 0.0, int16_scale: bool = True,
                generator: Optional[torch.Generator] = None):
    """Log-mel fbank of a wav in [-1, 1]: (..., N) -> (..., T, bins), T =
    1 + (N - window) // shift. ``dither > 0`` draws from ``generator``."""
    window_size = int(sample_rate * frame_length_ms / 1000.0)
    shift = int(sample_rate * frame_shift_ms / 1000.0)
    fft_size = 1 << (window_size - 1).bit_length()
    n = wav.shape[-1]
    if n < window_size:
        raise ValueError(f"waveform too short: {n} < {window_size}")
    x = wav.float()
    if int16_scale:
        x = x * 32768.0
    frames = x.unfold(-1, window_size, shift)  # (..., T, W)
    if dither > 0.0:
        if generator is None:
            raise ValueError("dither > 0 requires a generator")
        frames = frames + dither * torch.randn(
            frames.shape, generator=generator, device=frames.device)
    if remove_dc_offset:
        frames = frames - frames.mean(-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    window, banks = _constants(window_size, fft_size, num_mel_bins,
                               float(sample_rate), low_freq, high_freq,
                               x.device)
    spec = torch.fft.rfft(frames * window, n=fft_size, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel = torch.einsum("...tf,mf->...tm", power, banks)
    return torch.log(torch.clamp(mel, min=_FLOAT32_EPS))


@functools.lru_cache(maxsize=16)
def _lfr_index(t: int, lfr_m: int, lfr_n: int, device) -> torch.Tensor:
    """The (ceil(t / n) * m,) frame index of :func:`apply_lfr` on
    ``device``, copied once."""
    t_lfr = math.ceil(t / lfr_n)
    left = (lfr_m - 1) // 2
    idx = np.arange(t_lfr)[:, None] * lfr_n + np.arange(lfr_m)[None, :]
    # clamp into the left-padded sequence (the tail repeats the last
    # frame), then map back: padded rows before ``left`` are frame 0
    idx = np.maximum(np.minimum(idx, t + left - 1) - left, 0)
    return torch.as_tensor(idx.reshape(-1), device=device)


def apply_lfr(feats, lfr_m: int = 7, lfr_n: int = 6):
    """Low-frame-rate stacking: (..., T, D) -> (..., ceil(T / n), m D)."""
    t, d = feats.shape[-2], feats.shape[-1]
    stacked = feats[..., _lfr_index(t, lfr_m, lfr_n, feats.device), :]
    return stacked.reshape(*feats.shape[:-2], math.ceil(t / lfr_n),
                           lfr_m * d)


def load_kaldi_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a Kaldi nnet text CMVN file (``am.mvn``) -> (addshift,
    rescale), each (D,) fp32."""
    with open(path) as f:
        text = f.read()

    def block(tag):
        m = re.search(re.escape(tag) + r".*?\[([^\]]*)\]", text, flags=re.S)
        if m is None:
            raise ValueError(f"{tag} block not found in {path}")
        return np.array([float(v) for v in m.group(1).split()],
                        dtype=np.float32)

    addshift, rescale = block("<AddShift>"), block("<Rescale>")
    if addshift.shape != rescale.shape:
        raise ValueError(
            f"CMVN dim mismatch: {addshift.shape} vs {rescale.shape}")
    return addshift, rescale


def apply_cmvn(feats, addshift, rescale):
    """``(x + addshift) * rescale`` along the last dim."""
    return (feats + torch.as_tensor(addshift, device=feats.device)) \
        * torch.as_tensor(rescale, device=feats.device)


class SenseVoiceFrontend:
    """The teacher's whole feature chain: fbank, LFR, and CMVN from
    ``cmvn_file`` (none: no normalization). Output dim n_mels * lfr_m
    (560)."""

    def __init__(self, cmvn_file: Optional[str] = None, n_mels: int = 80,
                 frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                 lfr_m: int = 7, lfr_n: int = 6, dither: float = 0.0,
                 sample_rate: int = 16000):
        self.n_mels, self.lfr_m, self.lfr_n = n_mels, lfr_m, lfr_n
        self.frame_length_ms = frame_length_ms
        self.frame_shift_ms = frame_shift_ms
        self.dither, self.sample_rate = dither, sample_rate
        self.cmvn = load_kaldi_cmvn(cmvn_file) if cmvn_file else None
        if self.cmvn is not None and self.cmvn[0].shape[0] != n_mels * lfr_m:
            raise ValueError(f"CMVN dim {self.cmvn[0].shape[0]} != "
                             f"n_mels*lfr_m {n_mels * lfr_m}")
        self._cmvn_on = {}  # device -> (addshift, rescale), copied once

    @property
    def output_dim(self) -> int:
        return self.n_mels * self.lfr_m

    def __call__(self, wav, generator=None):
        """(..., N) wav in [-1, 1] -> (..., ceil(T / lfr_n), 560)."""
        feats = kaldi_fbank(
            wav, sample_rate=self.sample_rate, num_mel_bins=self.n_mels,
            frame_length_ms=self.frame_length_ms,
            frame_shift_ms=self.frame_shift_ms, dither=self.dither,
            generator=generator)
        feats = apply_lfr(feats, self.lfr_m, self.lfr_n)
        if self.cmvn is not None:
            if feats.device not in self._cmvn_on:
                self._cmvn_on[feats.device] = tuple(
                    torch.as_tensor(v, device=feats.device)
                    for v in self.cmvn)
            feats = apply_cmvn(feats, *self._cmvn_on[feats.device])
        return feats
