"""ctypes bindings for the native (C++) audio loader.

Port of ``unified_audio_tpu/data/native_loader.py`` over the port's own
copy of the loader, ``unified_audio_tpu_torch/csrc/audio_loader.cpp``. The
shared library is built with g++ at first use into ``build/kernels/`` at
the repository root (beside the CUDA builds of ``ops/cuda/build.py``), its
file name carrying a hash of the source and the flags. With no compiler,
or a build that fails, :func:`get_library` raises: nothing falls back to
another loader. Nothing is built at import time.

* :func:`read_wav_native` decodes one file's first channel (PCM16/24/32,
  float32) -> (samples float32 numpy, rate).
* :class:`NativeAudioLoader` prefetches random fixed-length crops on C++
  threads; ``next()`` returns a float32 CPU tensor (batch, crop_len),
  pinned when asked, for a ``non_blocking`` copy to the card. A file
  shorter than the crop is repeated to fill it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..ops.cuda.build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "audio_loader.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
MAX_RATE = 48000  # read_wav_native's buffer: max_seconds at this rate

_lib = None


def _build_library() -> Path:
    """The loader's shared library, compiled if it is missing (to a
    temporary name, then renamed into place)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native audio loader unavailable: no g++ on PATH")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"libaudio_loader_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build_library()))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.wav_read.restype = ctypes.c_int
        lib.wav_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        get_library()
        return True
    except RuntimeError:
        return False


def read_wav_native(path, max_seconds: float = 600.0):
    """-> (samples (T,) float32, sample_rate): the first channel, at most
    ``max_seconds`` at 48 kHz of samples."""
    lib = get_library()
    max_len = int(max_seconds * MAX_RATE)
    buf = np.empty(max_len, np.float32)
    sr = ctypes.c_int(0)
    n = lib.wav_read(
        str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_len, ctypes.byref(sr))
    if n < 0:
        raise IOError(f"failed to read {path}")
    return buf[:n].copy(), sr.value


class NativeAudioLoader:
    """Background C++ prefetch of random fixed-length crops from ``paths``
    (``workers`` threads, seeded ``seed + 7919 * worker``, ``capacity``
    batches queued). ``next()`` -> float32 CPU tensor (batch, crop_len),
    in pinned memory with ``pin_memory``. Use as a context manager."""

    def __init__(self, paths: Sequence, crop_len: int, batch: int,
                 workers: int = 4, capacity: int = 4, seed: int = 0,
                 pin_memory: bool = False):
        self.lib = get_library()
        self.crop_len, self.batch = crop_len, batch
        self.pin_memory = pin_memory
        encoded = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        self.handle = self.lib.loader_create(
            arr, len(encoded), crop_len, batch, workers, capacity, seed)

    def next(self) -> torch.Tensor:
        out = torch.empty((self.batch, self.crop_len), dtype=torch.float32,
                          pin_memory=self.pin_memory)
        if not self.lib.loader_next(self.handle, out.data_ptr()):
            raise StopIteration
        return out

    def close(self):
        if self.handle:
            self.lib.loader_destroy(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
