"""The port's signal ops (``unified_audio_tpu_torch/ops/dsp.py``) against the
JAX package's ``ops/dsp.py`` on the CPU: windowed-sinc ``resample``, the
STFT of HCodec-2.0's encoder, the cosine window, the MDCT and its inverse
("same" and "center" padding) and UniSE's log-mel frontend.

Tolerances: resampled samples within 1e-5 (abs); STFT bins within 1e-5 of
the spectrum's peak (complex difference, so magnitude and phase alike), and
at the DC and Nyquist bins, whose imaginary part is exactly zero for a real
signal, the same phase exactly (0 or pi, never -pi). MDCT coefficients,
the inverse and the log-mel within atol/rtol 1e-4.
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


def test_cosine_window_matches_jax():
    np.testing.assert_allclose(t_dsp.cosine_window(512).numpy(),
                               np.asarray(j_dsp.cosine_window(512)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("frame_len", [512, 64])
@pytest.mark.parametrize("padding", ["same", "center"])
def test_mdct_imdct_match_jax(frame_len, padding):
    """Coefficients and the inverse within 1e-4 of JAX's; the round trip
    gives the signal back away from the ends."""
    x = np.random.default_rng(frame_len).standard_normal(
        (2, 32 * frame_len)).astype(np.float32)
    want = np.array(j_dsp.mdct(jnp.asarray(x), frame_len, padding))
    got = t_dsp.mdct(torch.as_tensor(x), frame_len, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    want_y = np.asarray(j_dsp.imdct(jnp.asarray(want), padding))
    got_y = t_dsp.imdct(torch.as_tensor(want), padding).numpy()
    assert got_y.shape == want_y.shape == x.shape
    np.testing.assert_allclose(got_y, want_y, atol=1e-4, rtol=1e-4)
    inner = slice(frame_len, -frame_len)
    np.testing.assert_allclose(got_y[:, inner], x[:, inner], atol=1e-3)


def test_mdct_bad_padding_raises():
    """mdct refuses any other padding in both packages; the port's imdct
    refuses it too (the JAX package's takes it for "same")."""
    x = np.zeros((1, 1024), np.float32)
    with pytest.raises(ValueError):
        j_dsp.mdct(jnp.asarray(x), 64, "valid")
    with pytest.raises(ValueError):
        t_dsp.mdct(torch.as_tensor(x), 64, "valid")
    with pytest.raises(ValueError):
        t_dsp.imdct(torch.zeros(1, 4, 32), "valid")


@pytest.mark.parametrize("n", [16000, 16123])
def test_stft_logmel_matches_jax(n):
    """UniSE's frontend sizes (640, 320, 640, 80 mels), on a length the
    hop divides and one it does not; also through ``UniSE.stft_logmel``."""
    from unified_audio_tpu.models.unise import model as j_model
    from unified_audio_tpu_torch.models.unise import model as t_model

    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    want = np.asarray(j_dsp.stft_logmel(jnp.asarray(x), 640, 320, 640, 80))
    got = t_dsp.stft_logmel(torch.as_tensor(x), 640, 320, 640, 80).numpy()
    assert got.shape == want.shape == (2, -(-n // 320), 80)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    cfg = j_model.UniSEConfig()
    want_m = np.asarray(j_model.UniSE.stft_logmel(
        type("Held", (), {"config": cfg})(), jnp.asarray(x)))
    unise = t_model.UniSE(t_model.UniSEConfig(), None, None, None)
    got_m = unise.stft_logmel(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got_m, want_m, atol=1e-4, rtol=1e-4)
