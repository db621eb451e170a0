# Frozen copy of unified_audio_tpu_torch/ops/dsp.py, kept as plain PyTorch for
# the benchmark's reference: imports rewritten to this folder, no CUDA kernel.
"""Signal ops of HCodec, of BiCodec's speaker branch, of UniSE's log-mel
frontend and of the CLI's input preparation: the periodic Hann and the
cosine windows, framing, the STFT, overlap-add, the "same"-padded ISTFT,
windowed-sinc resampling, the slaney/htk mel filterbanks, the slaney mel
spectrogram, UniSE's htk log-mel, and the MDCT and its inverse.

Port of ``hann_window``, ``cosine_window``, ``frame``, ``stft``,
``overlap_add``, ``istft_same``, ``_resample_kernel``, ``resample``,
``_hz_to_mel``, ``_mel_to_hz``, ``melscale_fbanks``, ``stft_logmel``,
``mel_spectrogram``, ``mdct`` and ``imdct`` in
``unified_audio_tpu/ops/dsp.py``, in fp32 (complex64 for the FFTs, as the
JAX package casts) with the same arithmetic order
(overlap-add as r = L / hop shifted adds, in the JAX package's order; the
resampling lowpass as one strided convolution of the same polyphase
table, which this module computes with its own numpy copy of the JAX
package's formula; the filterbanks in fp64 numpy, cast to fp32).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, fp32: 0.5 - 0.5 cos(2 pi n / N)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def cosine_window(win_length: int, device=None) -> torch.Tensor:
    """Symmetric cosine (sine) window, fp32: sin(pi (n + 0.5) / N)
    (scipy.signal.windows.cosine)."""
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return torch.sin(math.pi / win_length * (n + 0.5))


def frame(x: torch.Tensor, frame_length: int, hop_length: int):
    """(..., T) -> (..., 1 + (T - frame_length) // hop, frame_length)
    overlapping frames (views of ``x``); T >= frame_length."""
    return x.unfold(-1, frame_length, hop_length)


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, center: bool = False):
    """Complex STFT of (..., T) -> (..., n_fft // 2 + 1, frames), onesided,
    unnormalized (torch.stft semantics): a periodic Hann window of
    ``win_length`` (default n_fft) zero-padded to n_fft in the middle;
    uncentered by default (1 + (T - n_fft) // hop frames, as HCodec-2.0's
    encoder calls it), or with ``center`` the signal reflect-padded by
    n_fft // 2 on both sides first.

    A real signal's DC and Nyquist bins have an imaginary part of exactly
    zero, and its sign decides ``angle`` where the real part is negative
    (+pi or -pi). The sign is pinned to +0.0, what the JAX package's rfft
    gives on the CPU, whatever FFT library computed the spectrum."""
    win_length = win_length or n_fft
    window = hann_window(win_length, x.device)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = F.pad(window, (left, n_fft - win_length - left))
    if center:
        shape = x.shape
        x = F.pad(x.reshape(-1, 1, shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(*shape[:-1], -1)
    spec = torch.fft.rfft(frame(x, n_fft, hop_length) * window, n=n_fft,
                          dim=-1)
    parts = torch.view_as_real(spec)  # a view: writes go to ``spec``
    parts[..., 0, 1] = 0.0
    if n_fft % 2 == 0:
        parts[..., -1, 1] = 0.0
    return spec.transpose(-1, -2)


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


LOWPASS_FILTER_WIDTH = 6  # zero crossings of the sinc on each side
ROLLOFF = 0.99  # lowpass cutoff as a share of the lower Nyquist rate


@functools.lru_cache(maxsize=16)
def _resample_kernel(orig_freq: int, new_freq: int):
    """The polyphase windowed-sinc table of ``orig_freq`` -> ``new_freq``
    (torchaudio's ``sinc_interp_hann``), computed in fp64 on the host ->
    (kernels (n, 2 width + o) fp32, width, o, n) with o and n the rates
    divided by their gcd."""
    gcd = math.gcd(orig_freq, new_freq)
    orig_freq, new_freq = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig_freq, new_freq) * ROLLOFF
    width = math.ceil(LOWPASS_FILTER_WIDTH * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq,
                    dtype=np.float64)[None] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq \
        + idx
    t = np.clip(t * base_freq, -LOWPASS_FILTER_WIDTH, LOWPASS_FILTER_WIDTH)
    window = np.cos(t * np.pi / LOWPASS_FILTER_WIDTH / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width, orig_freq, new_freq


def resample(x: torch.Tensor, orig_freq: int, new_freq: int):
    """Polyphase windowed-sinc resampling of (..., T) -> (..., ceil(new T /
    orig)), on ``x``'s device: the lowpass is one convolution of stride o
    over ``x`` zero-padded by (width, width + o), one output channel per
    phase (torchaudio.functional.resample semantics, the JAX package's
    defaults)."""
    if orig_freq == new_freq:
        return x
    kernels, width, o, n = _resample_kernel(orig_freq, new_freq)
    shape, t = x.shape, x.shape[-1]
    x2 = F.pad(x.reshape(-1, 1, t).float(), (width, width + o))
    weight = torch.as_tensor(kernels, device=x.device)[:, None]
    y = F.conv1d(x2, weight, stride=o)  # (B, n, T // o + 1)
    y = y.transpose(1, 2).reshape(x2.shape[0], -1)
    target = math.ceil(n * t / o)
    return y[:, :target].reshape(*shape[:-1], target)


# ---------------------------------------------------------------------------
# Mel filterbanks (torchaudio semantics)
# ---------------------------------------------------------------------------

def _hz_to_mel(freq, mel_scale: str):
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney: linear below 1 kHz, logarithmic above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    if np.isscalar(freq):
        if freq >= min_log_hz:
            mels = min_log_mel + math.log(freq / min_log_hz) / logstep
        return mels
    return np.where(freq >= min_log_hz, min_log_mel + np.log(
        np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(mels, mel_scale: str):
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=32)
def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int, norm: Optional[str] = None,
                    mel_scale: str = "htk") -> np.ndarray:
    """Triangular mel filterbank (n_freqs, n_mels), fp32 numpy
    (torchaudio.functional.melscale_fbanks semantics; BiCodec's speaker
    mel uses slaney scale and slaney norm)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min, mel_scale),
                        _hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def stft_logmel(x: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, n_mels: int, sample_rate: int = 16000,
                f_max: float = 8000.0) -> torch.Tensor:
    """UniSE's log-mel frontend, (B, T) -> (B, frames, n_mels): the signal
    zero-padded to a multiple of the hop plus (win - hop) // 2 on each
    side, the uncentered STFT's magnitude, the htk mel filterbank without
    norm (0 Hz to ``f_max``), log(mel + 1e-10)."""
    t = x.shape[-1]
    pad_len = -(-t // hop_length) * hop_length - t
    side = (win_length - hop_length) // 2
    x = F.pad(x, (side, pad_len + side))
    mag = stft(x, n_fft, hop_length, win_length, center=False).abs()
    fb = _fbanks_on(n_fft // 2 + 1, 0.0, f_max, n_mels, sample_rate, None,
                    "htk", x.device)
    return torch.log(torch.einsum("bft,fm->btm", mag, fb) + 1e-10)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int,
                    win_length: int, hop_length: int, f_min: float,
                    f_max: float, n_mels: int) -> torch.Tensor:
    """Magnitude (power 1) mel spectrogram with slaney scale and norm, the
    centered, reflect-padded STFT (torchaudio.transforms.MelSpectrogram as
    BiCodec configures it; differentiable, as codec training's multi-scale
    mel loss needs). (B, T) -> (B, n_mels, frames)."""
    mag = stft(x, n_fft, hop_length, win_length, center=True).abs()
    fb = _fbanks_on(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate,
                    "slaney", "slaney", x.device)
    return torch.einsum("bft,fm->bmt", mag, fb.to(mag.dtype))


@functools.lru_cache(maxsize=64)
def _fbanks_on(n_freqs: int, f_min: float, f_max: float, n_mels: int,
               sample_rate: int, norm: Optional[str], mel_scale: str,
               device) -> torch.Tensor:
    """:func:`melscale_fbanks` as a tensor on ``device``, copied there
    once (a copy from pageable host memory waits for the card)."""
    return torch.as_tensor(melscale_fbanks(
        n_freqs, f_min, f_max, n_mels, sample_rate, norm=norm,
        mel_scale=mel_scale), device=device)


# ---------------------------------------------------------------------------
# MDCT / IMDCT ("same" or "center" padding)
# ---------------------------------------------------------------------------

def _mdct_pad(frame_len: int, padding: str) -> int:
    if padding == "center":
        return frame_len // 2
    if padding == "same":
        return frame_len // 4
    raise ValueError("padding must be 'center' or 'same'")


def mdct(audio: torch.Tensor, frame_len: int,
         padding: str = "same") -> torch.Tensor:
    """(B, T) -> (B, L, N) MDCT coefficients, N = frame_len // 2: the
    signal zero-padded by frame_len // 4 ("same") or // 2 ("center") on
    each side, cut into frames of ``frame_len`` at hop N, each windowed by
    :func:`cosine_window` and transformed through one complex64 FFT with
    pre- and post-twiddles, scaled by sqrt(2 / N)."""
    pad = _mdct_pad(frame_len, padding)
    audio = F.pad(audio, (pad, pad))
    dev, n = audio.device, frame_len // 2
    x = frame(audio, frame_len, n) * cosine_window(frame_len, dev)
    k = torch.arange(frame_len, dtype=torch.float32, device=dev)
    pre = torch.exp(-1j * math.pi * k / frame_len)
    big_x = torch.fft.fft(x * pre, dim=-1)[..., :n]
    n0 = (n + 1) / 2
    j = torch.arange(n, dtype=torch.float32, device=dev)
    post = torch.exp(-1j * math.pi * n0 * (j + 0.5) / n)
    res = big_x * post * math.sqrt(1 / n)
    return res.real * math.sqrt(2)


def imdct(coeffs: torch.Tensor, padding: str = "same") -> torch.Tensor:
    """(B, L, N) -> (B, (L + 1) N - 2 pad) inverse MDCT: each frame's
    complex64 inverse FFT with twiddles, windowed by :func:`cosine_window`,
    overlap-added at hop N, the padding of :func:`mdct` trimmed. A
    ``padding`` other than "same" or "center" raises, as in :func:`mdct`
    (the JAX package's ``imdct`` takes any other string for "same")."""
    pad = _mdct_pad(2 * coeffs.shape[-1], padding)
    n, dev = coeffs.shape[-1], coeffs.device
    frame_len = 2 * n
    big_y = torch.cat([coeffs, -torch.flip(coeffs, dims=(-1,))],
                      dim=-1).to(torch.complex64)
    n0 = (n + 1) / 2
    m = torch.arange(frame_len, dtype=torch.float32, device=dev)
    pre = torch.exp(1j * math.pi * n0 * m / n)
    post = torch.exp(1j * math.pi * (m + n0) / frame_len)
    y = torch.fft.ifft(big_y * pre, dim=-1)
    y = (y * post).real * math.sqrt(n) * math.sqrt(2)
    audio = overlap_add(y * cosine_window(frame_len, dev), n)
    return audio[..., pad:-pad]
