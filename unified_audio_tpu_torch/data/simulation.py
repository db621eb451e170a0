"""On-the-fly degradation simulator (host-side numpy/scipy).

The port's own copy of ``unified_audio_tpu/data/simulation.py`` (the port
imports nothing of the JAX package), unchanged in its arithmetic and in the
order of its random draws: SIR-mixed interference, RIR reverb (the full RIR
on the mixture, the early-reflection RIR on the target), silence-aware SNR
noise mixing, bandwidth limitation (polyphase resample down and up), quantile
clipping, packet loss, a random order of the last three, and clip-protection
normalization.

All functions operate on (channels, time) float arrays and draw from an
explicit ``np.random.Generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import scipy.signal


# ---------------------------------------------------------------------------
# VAD (detect_non_silence.py)
# ---------------------------------------------------------------------------

def detect_non_silence(
    x: np.ndarray,
    threshold: float = 0.01,
    frame_length: int = 1024,
    frame_shift: int = 512,
) -> np.ndarray:
    """Power-based VAD mask, same shape bool array."""
    if x.shape[-1] < frame_length:
        return np.full(x.shape, True, dtype=bool)
    nadd = (-(x.shape[-1] - frame_length) % frame_shift) % frame_length
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, nadd)])
    shape = xp.shape[:-1] + (
        (xp.shape[-1] - frame_length) // frame_shift + 1, frame_length
    )
    strides = xp.strides[:-1] + (frame_shift * xp.strides[-1], xp.strides[-1])
    frames = np.lib.stride_tricks.as_strided(xp, shape=shape, strides=strides)
    power = frames.var(axis=-1)
    mean_power = np.mean(power, axis=-1, keepdims=True)
    if np.all(mean_power == 0):
        return np.full(x.shape, True, dtype=bool)
    detect = power / mean_power > threshold
    detects = np.broadcast_to(
        detect[..., None], detect.shape + (frame_shift,)
    ).reshape(*detect.shape[:-1], -1)
    return np.pad(
        detects,
        [(0, 0)] * (x.ndim - 1) + [(0, x.shape[-1] - detects.shape[-1])],
        mode="edge",
    )


# ---------------------------------------------------------------------------
# RIR helpers (rir_utils.py:5-15, 129-182)
# ---------------------------------------------------------------------------

def add_reverberation(speech: np.ndarray, rir: np.ndarray) -> np.ndarray:
    rev = scipy.signal.fftconvolve(speech, rir, mode="full")
    return rev[:, : speech.shape[1]]


def get_rir_start_end(h: np.ndarray, level_ratio: float = 1e-1):
    abs_h = np.abs(h)
    max_index = int(np.argmax(abs_h))
    max_val = abs_h[max_index]
    larger = abs_h[: max_index + 1] > level_ratio * max_val
    smaller = abs_h[max_index + 1:] < level_ratio * max_val
    start = int(np.argmax(larger))
    end = int(np.argmax(smaller)) + max_index + 1
    return start, end


def estimate_early_rir(rir: np.ndarray, fs: int = 48000) -> np.ndarray:
    """Keep only the direct-path/early window of each RIR channel."""
    early = np.zeros_like(rir)
    for i in range(rir.shape[0]):
        start, end = get_rir_start_end(rir[i])
        early[i, start:end] = rir[i, start:end]
    return early


# ---------------------------------------------------------------------------
# Individual distortions (simulate.py:10-123)
# ---------------------------------------------------------------------------

def mix_noise(speech, noise, snr, rng: np.random.Generator):
    ls, ln = speech.shape[-1], noise.shape[-1]
    if ln < ls:
        offset = rng.integers(0, ls - ln)
        noise = np.pad(noise, [(0, 0), (offset, ls - ln - offset)], mode="wrap")
    elif ln > ls:
        offset = rng.integers(0, ln - ls)
        noise = noise[:, offset : offset + ls]
    rms_noise = noise[detect_non_silence(noise)].std()
    rms_speech = speech[detect_non_silence(speech)].std()
    scale = 10 ** (-snr / 20) * rms_speech / (rms_noise + 1e-10)
    return noise * scale + speech


def bandwidth_limitation(speech, fs: int, fs_new: int) -> np.ndarray:
    if fs == fs_new:
        return speech
    assert fs > fs_new
    g = math.gcd(fs, fs_new)
    down = scipy.signal.resample_poly(speech, fs_new // g, fs // g, axis=-1)
    up = scipy.signal.resample_poly(down, fs // g, fs_new // g, axis=-1)
    return up[:, : speech.shape[1]]


def clipping(speech, min_quantile=0.1, max_quantile=0.9) -> np.ndarray:
    lo, hi = np.quantile(speech, [min_quantile, max_quantile], axis=-1)
    return np.stack(
        [np.clip(speech[i], lo[i], hi[i]) for i in range(speech.shape[0])]
    )


def packet_loss_indices(
    length, fs, packet_ms, loss_rate, max_continuous, rng: np.random.Generator
) -> List[int]:
    dur_ms = length / fs * 1000
    num_packets = int(dur_ms // packet_ms)
    num_loss = int(round(loss_rate * dur_ms / packet_ms, 0))
    lengths = []
    for _ in range(num_loss):
        lengths.append(int(rng.integers(1, max_continuous)))
        if num_loss - sum(lengths) <= max_continuous:
            lengths.append(num_loss - sum(lengths))
            break
    if not lengths:
        return []
    starts = rng.choice(range(num_packets), len(lengths), replace=False)
    out = []
    for idx, ln in zip(starts, lengths):
        out += list(range(int(idx), int(idx) + ln))
    return sorted(set(out))


def apply_packet_loss(speech, fs, indices, packet_ms=20):
    speech = speech.copy()
    for idx in indices:
        start = idx * packet_ms * fs // 1000
        end = (idx + 1) * packet_ms * fs // 1000
        speech[:, start:end] = 0
    return speech


# ---------------------------------------------------------------------------
# Full pipeline (simulate.py:126-192 + simulation_train.yaml defaults)
# ---------------------------------------------------------------------------

DEFAULT_SIM_CONFIG: Dict = {
    "se_interference": {"prob": 0.2, "sir": [2.0, 20.0]},
    "tse_interference": {"sir": [-5.0, 5.0]},
    "reverberation": {"prob": 0.3},
    "noise": {"prob": 0.8, "snr": [-5.0, 20.0]},
    "bandwidth_limitation": {"prob": 0.3, "fs_new": [4000, 8000, 16000]},
    "clipping": {"prob": 0.3, "min_quantile": [0.0, 0.1],
                 "max_quantile": [0.9, 1.0]},
    "packet_loss": {"prob": 0.3, "packet_duration_ms": 20,
                    "packet_loss_rate": [0.05, 0.25],
                    "max_continuous_packet_loss": 10},
}


def simulate_data(
    mode: str,
    speech: np.ndarray,
    interf: Optional[np.ndarray],
    noise: Optional[np.ndarray],
    rir: Optional[np.ndarray],
    fs: int,
    config: Optional[Dict] = None,
    rng: Optional[np.random.Generator] = None,
):
    """-> (noisy, speech, interf); all (1, T)."""
    config = config or DEFAULT_SIM_CONFIG
    rng = rng or np.random.default_rng()

    if mode in ("tse", "rtse"):
        sir = rng.uniform(*config["tse_interference"]["sir"])
    else:
        sir = rng.uniform(*config["se_interference"]["sir"])
    snr = rng.uniform(*config["noise"]["snr"])
    fs_new = int(rng.choice(config["bandwidth_limitation"]["fs_new"]))
    min_q = rng.uniform(*config["clipping"]["min_quantile"])
    max_q = rng.uniform(*config["clipping"]["max_quantile"])
    pl_cfg = config["packet_loss"]

    if interf is not None:
        noisy = mix_noise(speech, interf, snr=sir, rng=rng)
        interf = noisy - speech
    else:
        noisy = speech.copy()

    if rng.random() < config["reverberation"]["prob"] and rir is not None:
        rir = rir / (np.max(np.abs(rir)) + 1e-5)
        noisy = add_reverberation(noisy, rir)
        early = estimate_early_rir(rir, fs=fs)
        speech = add_reverberation(speech, early)
        if interf is not None:
            interf = add_reverberation(interf, early)

    if rng.random() < config["noise"]["prob"] and noise is not None:
        noisy = mix_noise(noisy, noise, snr=snr, rng=rng)

    order = [0, 1, 2]
    rng.shuffle(order)
    for o in order:
        if o == 0 and rng.random() < config["bandwidth_limitation"]["prob"]:
            noisy = bandwidth_limitation(noisy, fs, fs_new)
        elif o == 1 and rng.random() < config["clipping"]["prob"]:
            noisy = clipping(noisy, min_q, max_q)
        elif o == 2 and rng.random() < pl_cfg["prob"]:
            idx = packet_loss_indices(
                speech.shape[-1], fs, pl_cfg["packet_duration_ms"],
                rng.uniform(*pl_cfg["packet_loss_rate"]),
                pl_cfg["max_continuous_packet_loss"], rng,
            )
            noisy = apply_packet_loss(noisy, fs, idx,
                                      pl_cfg["packet_duration_ms"])

    max_val = max(np.max(np.abs(noisy)), np.max(np.abs(speech)))
    if interf is not None:
        max_val = max(max_val, np.max(np.abs(interf)))
    if max_val > 0.99:
        scale = 0.99 / max_val
        noisy, speech = noisy * scale, speech * scale
        if interf is not None:
            interf = interf * scale
    return noisy, speech, interf
