"""Minimal WAV I/O on the stdlib ``wave`` module and numpy.

The port's own copy of ``unified_audio_tpu/data/audio_io.py`` (the port
imports nothing of the JAX package). Reads PCM16/PCM24/PCM32 and float32,
mono or multi-channel; writes PCM16."""
from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path) -> Tuple[np.ndarray, int]:
    """-> (samples (channels, T) float32 in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        header = f.read(12)
        assert header[:4] == b"RIFF" and header[8:12] == b"WAVE", path
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload[:size]
        assert fmt is not None and data is not None, path
        audio_format, channels, rate, _, _, bits = fmt
        if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported wav format {fmt} in {path}")
        x = x.reshape(-1, channels).T
        return np.ascontiguousarray(x), rate


def write_wav(path, samples: np.ndarray, sample_rate: int):
    """samples (T,) or (channels, T) float in [-1, 1] -> PCM16 wav."""
    if samples.ndim == 1:
        samples = samples[None]
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2").T  # (T, C) interleaved
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
