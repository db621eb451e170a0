"""The port's native audio loader (``unified_audio_tpu_torch/data/
native_loader.py`` over its own copy of ``audio_loader.cpp``) against the
JAX package's, on the CPU; both are built with g++ here.

The same wavs (PCM16, PCM24, float32, stereo) decode bit-equal; with one
worker and one seed both loaders give equal batches (the C++ code is the
same, so the crop offsets draw alike); a file shorter than the crop is
wrap-padded; the port returns float32 CPU tensors and builds into
``build/kernels/``.
"""
import wave

import numpy as np
import pytest
import torch

from unified_audio_tpu.data import native_loader as j_nl
from unified_audio_tpu_torch.data import native_loader as t_nl
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.ops.cuda.build import BUILD_DIR


def _write_pcm(path, samples, rate, width, channels=1):
    """A PCM wav of ``width`` bytes a sample from floats in [-1, 1)."""
    scale = float(2 ** (8 * width - 1))
    ints = np.clip(np.round(samples * scale), -scale, scale - 1).astype(
        np.int64)
    raw = b"".join(int(v).to_bytes(width, "little", signed=True)
                   for v in ints.reshape(-1))
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw)


def _write_float(path, samples, rate):
    """A mono IEEE-float wav (format 3), which ``wave`` cannot write."""
    data = samples.astype("<f4").tobytes()
    fmt = (np.array([3, 1], "<u2").tobytes() + np.array([rate], "<u4")
           .tobytes() + np.array([rate * 4], "<u4").tobytes()
           + np.array([4, 32], "<u2").tobytes())
    body = (b"WAVE" + b"fmt " + np.array([16], "<u4").tobytes() + fmt
            + b"data" + np.array([len(data)], "<u4").tobytes() + data)
    path.write_bytes(b"RIFF" + np.array([len(body)], "<u4").tobytes() + body)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    x = lambda n: (0.5 * rng.uniform(-1, 1, n)).astype(np.float32)  # noqa
    paths = {"pcm16": d / "a.wav", "pcm24": d / "b.wav",
             "float32": d / "c.wav", "stereo": d / "d.wav",
             "short": d / "e.wav"}
    write_wav(paths["pcm16"], x(4000), 16000)
    _write_pcm(paths["pcm24"], x(3000), 22050, 3)
    _write_float(paths["float32"], x(5000), 48000)
    _write_pcm(paths["stereo"], x(2 * 2500), 16000, 2, channels=2)
    write_wav(paths["short"], x(300), 16000)
    return paths


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "float32", "stereo"])
def test_read_wav_bit_equal_to_jax(wavs, kind):
    got, sr = t_nl.read_wav_native(wavs[kind])
    want, want_sr = j_nl.read_wav_native(wavs[kind])
    assert sr == want_sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_wav_missing_raises(tmp_path):
    with pytest.raises(IOError):
        t_nl.read_wav_native(tmp_path / "missing.wav")


def test_loader_batches_equal_jax(wavs):
    """One worker, one seed: the same batches in the same order, as float32
    CPU tensors (batch, crop)."""
    paths = [wavs[k] for k in ("pcm16", "pcm24", "float32", "short")]
    with t_nl.NativeAudioLoader(paths, 1000, 3, workers=1, seed=7) as tl, \
            j_nl.NativeAudioLoader(paths, 1000, 3, workers=1, seed=7) as jl:
        for _ in range(4):
            got, want = tl.next(), jl.next()
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            assert got.dtype == torch.float32 and got.shape == (3, 1000)
            np.testing.assert_array_equal(got.numpy(), want)


def test_loader_wrap_pads_short_files(wavs):
    """A 300-sample file under a 1000-sample crop repeats from its start."""
    samples, _ = t_nl.read_wav_native(wavs["short"])
    with t_nl.NativeAudioLoader([wavs["short"]], 1000, 2, workers=1) as ld:
        batch = ld.next().numpy()
    want = np.resize(samples, 1000)
    np.testing.assert_array_equal(batch, np.stack([want, want]))


def test_builds_into_build_kernels():
    assert t_nl.native_available()
    assert list(BUILD_DIR.glob("libaudio_loader_*.so"))
