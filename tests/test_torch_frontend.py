"""Port vs JAX: the 1-D conv primitives and the WavLM frontend.

WavLM-tiny carries the relative-position bias, as the full WavLM-base-plus
does. Tolerance: atol/rtol 1e-4 (different reduction order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (TOL, port_wavlm, tiny_wavlm_config,
                               wavlm_variables)
from unified_audio_tpu.models.ssl import wav2vec2 as j_ssl
from unified_audio_tpu.nn import conv as j_conv
from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl
from unified_audio_tpu_torch.nn import conv as t_conv


@pytest.mark.parametrize("k,stride,dilation,groups,pad", [
    (7, 1, 1, 1, 3), (7, 1, 3, 4, 9), (4, 2, 1, 1, 1), (1, 1, 1, 1, 0),
    (16, 1, 1, 4, 8)])
def test_conv1d(k, stride, dilation, groups, pad):
    rng = np.random.default_rng(k + groups)
    x = rng.standard_normal((2, 23, 8)).astype(np.float32)
    kernel = rng.standard_normal((k, 8 // groups, 12)).astype(np.float32)
    want = j_conv.conv1d(jnp.asarray(x), jnp.asarray(kernel), stride,
                         dilation, groups, padding=(pad, pad))
    got = t_conv.conv1d(torch.as_tensor(x),
                        torch.as_tensor(kernel.transpose(2, 1, 0).copy()),
                        stride=stride, dilation=dilation, groups=groups,
                        padding=(pad, pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,stride,pad,opad", [(11, 5, 3, 0), (16, 8, 4, 0),
                                               (6, 3, None, None),
                                               (4, 2, None, None)])
def test_conv_transpose1d(k, stride, pad, opad):
    """torch padding/output_padding trim of the full transposed conv."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    kernel = rng.standard_normal((k, 6, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    m = j_conv.ConvTranspose1d(5, k, stride, padding=pad, output_padding=opad)
    want = m.apply({"params": {"kernel": jnp.asarray(kernel),
                               "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    t = t_conv.ConvTranspose1d(6, 5, k, stride, padding=pad,
                               output_padding=opad)
    t.load_state_dict({"weight": torch.as_tensor(
        kernel.transpose(1, 2, 0).copy()), "bias": torch.as_tensor(bias)})
    with torch.no_grad():
        got = t(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def wavlm():
    cfg = tiny_wavlm_config()
    variables = wavlm_variables(cfg)
    return cfg, j_ssl.Wav2Vec2Model(cfg), variables, port_wavlm(cfg, variables)


def test_wavlm_features(wavlm):
    """The UniSE feature path: ±160-sample pad, all hidden states, mean."""
    cfg, model, variables, tm = wavlm
    wav = (0.3 * np.random.default_rng(3).standard_normal(
        (2, 6400))).astype(np.float32)
    padded = np.pad(wav, [(0, 0), (160, 160)])
    jhs = jax.jit(model.apply)(variables, jnp.asarray(padded))
    with torch.no_grad():
        ths = tm(torch.as_tensor(padded))
    assert len(ths) == len(jhs) == cfg.num_layers + 1
    for j, t in zip(jhs, ths):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(
        t_ssl.wavlm_features(ths).numpy(),
        np.asarray(j_ssl.wavlm_features(jhs)), **TOL)
    assert t_ssl.conv_frames(t_ssl.SSLConfig(**dataclasses.asdict(cfg)),
                             padded.shape[-1]) == jhs[0].shape[1]


def test_relative_position_buckets():
    want = np.asarray(j_ssl._relative_position_buckets(40, 40, 320, 800))
    np.testing.assert_array_equal(
        t_ssl.relative_position_buckets(40, 40, 320, 800), want)
