"""The port's signal ops (``unified_audio_tpu_torch/ops/dsp.py``) against the
JAX package's ``ops/dsp.py`` on the CPU: windowed-sinc ``resample`` and the
STFT of HCodec-2.0's encoder.

Tolerances: resampled samples within 1e-5 (abs); STFT bins within 1e-5 of
the spectrum's peak (complex difference, so magnitude and phase alike), and
at the DC and Nyquist bins, whose imaginary part is exactly zero for a real
signal, the same phase exactly (0 or pi, never -pi).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_audio_tpu.ops import dsp as j_dsp
from unified_audio_tpu_torch.ops import dsp as t_dsp


@pytest.mark.parametrize("orig,new,n", [(48000, 16000, 9601),
                                        (44100, 16000, 7001),
                                        (8000, 16000, 3333),
                                        (16000, 48000, 2501)])
def test_resample_matches_jax(orig, new, n):
    """Lengths the rate ratio does not divide; batch axes kept."""
    x = np.random.default_rng(n).standard_normal((2, 3, n)).astype(
        np.float32)
    want = np.asarray(j_dsp.resample(jnp.asarray(x), orig, new))
    got = t_dsp.resample(torch.as_tensor(x), orig, new)
    assert got.shape == want.shape == (2, 3, -(-n * new // orig))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_resample_same_rate_is_identity():
    x = torch.randn(2, 100)
    assert t_dsp.resample(x, 16000, 16000) is x


@pytest.mark.parametrize("n_fft,hop", [(1920, 960), (640, 320), (63, 16)])
def test_stft_matches_jax(n_fft, hop):
    """HCodec-2.0's (1920, 960) STFT, another even n_fft and an odd one (no
    Nyquist bin), uncentered as the encoder takes them."""
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((2, n_fft * 8)).astype(np.float32)
    x[1] -= 0.5  # a negative mean: negative real parts at DC
    want = np.asarray(j_dsp.stft(jnp.asarray(x), n_fft, hop, center=False))
    got = t_dsp.stft(torch.as_tensor(x), n_fft, hop).numpy()
    assert got.shape == want.shape
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * peak
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-5 * peak,
                               rtol=0)
    edges = [0, -1] if n_fft % 2 == 0 else [0]
    for k in edges:
        assert (want[:, k].imag == 0).all() and (got[:, k].imag == 0).all()
        assert not np.signbit(got[:, k].imag).any()
        np.testing.assert_array_equal(np.angle(got[:, k]) / np.pi,
                                      np.angle(want[:, k]) / np.pi)
    assert (want[:, 0].real < 0).any(), "no DC bin with a negative real part"


def test_stft_pins_the_zero_imaginary_sign(monkeypatch):
    """An FFT that returns -0.0 at DC and Nyquist (as another library may)
    still gives +0.0 there, so angle() is +pi where the real part is
    negative."""
    rfft = torch.fft.rfft

    def negative_zero(*args, **kwargs):
        spec = rfft(*args, **kwargs)
        parts = torch.view_as_real(spec)
        parts[..., 0, 1] = -0.0
        parts[..., -1, 1] = -0.0
        return spec

    monkeypatch.setattr(torch.fft, "rfft", negative_zero)
    x = torch.full((1, 1920 * 2), -1.0)  # DC bin real part negative
    spec = t_dsp.stft(x, 1920, 960)
    assert not torch.signbit(spec[:, 0].imag).any()
    assert not torch.signbit(spec[:, -1].imag).any()
    assert (spec[:, 0].angle() == torch.pi).all()


def test_frame_matches_jax():
    x = np.arange(2 * 50, dtype=np.float32).reshape(2, 50)
    np.testing.assert_array_equal(t_dsp.frame(torch.as_tensor(x), 12, 5),
                                  np.asarray(j_dsp.frame(jnp.asarray(x), 12,
                                                         5)))
