"""Port vs JAX: the tokenize side of BiCodec that UniSE's training runs on
its targets: the XLSR-53-shaped SSL encoder (17 pre-LN layers of width 16),
the slaney mel spectrogram, the factorized VQ's cosine search, residual
FSQ, the speaker encoder (ECAPA-TDNN with BatchNorm statistics, the
Perceiver), ``BiCodecTokenizer.tokenize`` on clips shorter and longer than
the reference segment, and the BiCodec converter.

Tolerances: hidden states within atol/rtol 1e-4; the mel within atol/rtol
1e-5; token ids exact. A token that differs prints the margin of its
decision.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (TOL, bicodec_variables, jax_tokenizer,
                               port_tokenizer, tiny_tokenizer_config,
                               tiny_xlsr_config, to_torch, xlsr_variables)
from unified_audio_tpu.models.bicodec.bicodec import BiCodec
from unified_audio_tpu.models.bicodec import tokenizer as j_tok
from unified_audio_tpu.models.ssl import wav2vec2 as j_ssl
from unified_audio_tpu.ops import dsp as j_dsp
from unified_audio_tpu.ops import quant as j_quant
from unified_audio_tpu.utils.convert_bicodec import export_bicodec_state_dict
from unified_audio_tpu_torch.models.bicodec import bicodec as t_bicodec
from unified_audio_tpu_torch.models.bicodec import tokenizer as t_tok
from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl
from unified_audio_tpu_torch.ops import dsp as t_dsp
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.utils import convert as t_convert


def _wav(n, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, n))).astype(np.float32)


@pytest.fixture(scope="module")
def tokenizers():
    tok = jax_tokenizer()
    return tok, port_tokenizer(tok)


def test_xlsr_hidden_states():
    cfg = tiny_xlsr_config()
    variables = xlsr_variables(cfg)
    wav = _wav(3200)
    want = jax.jit(j_ssl.Wav2Vec2Model(cfg).apply)(variables,
                                                   jnp.asarray(wav))
    m = t_ssl.Wav2Vec2Model(t_ssl.SSLConfig(**dataclasses.asdict(cfg)))
    m.load_state_dict(to_torch(t_convert.xlsr_state_dict(variables, cfg)))
    with torch.no_grad():
        got = m.eval()(torch.as_tensor(wav))
    assert len(got) == len(want) == 18
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(t_ssl.xlsr_features(got).numpy(),
                               np.asarray(j_ssl.xlsr_features(want)), **TOL)


def test_xlsr_config_matches():
    assert dataclasses.asdict(t_ssl.wav2vec2_large_xlsr53_config()) == \
        dataclasses.asdict(j_ssl.wav2vec2_large_xlsr53_config())


@pytest.mark.parametrize("norm,scale", [(None, "htk"), ("slaney", "slaney")])
def test_melscale_fbanks(norm, scale):
    args = (513, 10.0, 8000.0, 128, 16000, norm, scale)
    np.testing.assert_array_equal(t_dsp.melscale_fbanks(*args),
                                  j_dsp.melscale_fbanks(*args))


@pytest.mark.parametrize("shape", [
    (16000, 1024, 640, 320, 128),  # BiCodec's speaker mel
    (3200, 256, 160, 80, 32),  # the tiny config's
])
def test_mel_spectrogram(shape):
    n, n_fft, win, hop, mels = shape
    wav = _wav(n, seed=1)
    want = j_dsp.mel_spectrogram(jnp.asarray(wav), 16000, n_fft, win, hop,
                                 10.0, 8000.0, mels)
    got = t_dsp.mel_spectrogram(torch.as_tensor(wav), 16000, n_fft, win, hop,
                                10.0, 8000.0, mels)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_normalize_input_and_ref_clip(tokenizers):
    tok, ttok = tokenizers
    wav = _wav(1000, seed=2) + 0.05
    np.testing.assert_allclose(
        t_tok.normalize_input(torch.as_tensor(wav)).numpy(),
        np.asarray(j_tok.normalize_input(jnp.asarray(wav))), atol=1e-6,
        rtol=1e-6)
    for n in (1000, 3200, 5000):
        w = _wav(n, seed=3)
        np.testing.assert_array_equal(
            ttok.get_ref_clip(torch.as_tensor(w)).numpy(),
            np.asarray(tok.get_ref_clip(jnp.asarray(w))))


def _assert_tokens_equal(got, want, scores=None):
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got, want) and scores is not None:
        bad = np.argwhere(got != want)
        for idx in bad[:5]:
            row = scores[tuple(idx)]
            print(f"flip at {tuple(idx)}: port {got[tuple(idx)]}, jax "
                  f"{want[tuple(idx)]}, margin "
                  f"{abs(row[got[tuple(idx)]] - row[want[tuple(idx)]]):.3e}")
    np.testing.assert_array_equal(got, want)


def test_fvq_tokenize():
    fvq = j_quant.FactorizedVectorQuantize(input_dim=32, codebook_size=64,
                                           codebook_dim=8)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 30, 32)).astype(np.float32)
    variables = jax.jit(fvq.init)(jax.random.PRNGKey(1), jnp.asarray(z))
    want = jax.jit(lambda v, x: fvq.apply(v, x, method="tokenize"))(
        variables, jnp.asarray(z))
    m = t_quant.FactorizedVectorQuantize(32, 64, 8, tokenize=True)
    sd = {"codebook.weight": np.asarray(variables["params"]["codebook"])}
    for name in ("in_project", "out_project"):
        t_convert._conv(variables["params"][name], name, sd)
    m.load_state_dict(to_torch(sd))
    with torch.no_grad():
        zt = torch.as_tensor(z)
        got = m.tokenize(zt)
        e = m.in_project(zt)
        scores = torch.nn.functional.normalize(e, dim=-1) @ \
            torch.nn.functional.normalize(m.codebook.weight, dim=-1).T
    assert got.dtype == torch.int32
    _assert_tokens_equal(got.numpy(), want, scores.numpy())


@pytest.mark.parametrize("nq,levels", [(1, (4, 4, 4, 4, 4, 4)),
                                        (3, (5, 4, 3))])
def test_residual_fsq_indices(nq, levels):
    rfsq = j_quant.ResidualFSQ(levels=levels, num_quantizers=nq, dim=16)
    rng = np.random.default_rng(5)
    x = (2.0 * rng.standard_normal((2, 40, 16))).astype(np.float32)
    variables = jax.jit(rfsq.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    _, want = jax.jit(rfsq.apply)(variables, jnp.asarray(x))
    m = t_quant.ResidualFSQ(levels, nq, 16, tokenize=True)
    sd = {}
    for name in ("project_in", "project_out"):
        t_convert._linear(variables["params"][name], name, sd)
    m.load_state_dict(to_torch(sd))
    with torch.no_grad():
        got = m(torch.as_tensor(x))
    assert got.shape == (2, 40, nq) and got.dtype == torch.int32
    _assert_tokens_equal(got.numpy(), want)


def test_fsq_bound_and_codes():
    """``bound`` within 1e-6; codes and indices exact on values spread over
    every level."""
    z = np.linspace(-4, 4, 4001, dtype=np.float32).reshape(-1, 1).repeat(
        3, axis=1)
    jf, tf = j_quant.FSQ(levels=(4, 5, 3)), t_quant.FSQ((4, 5, 3))
    np.testing.assert_allclose(
        tf.bound(torch.as_tensor(z)).numpy(),
        np.asarray(jf.apply({}, jnp.asarray(z), method="bound")), atol=1e-6,
        rtol=1e-6)
    jc, ji = jf.apply({}, jnp.asarray(z))
    tc, ti = tf(torch.as_tensor(z))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_speaker_encoder_tokenize(tokenizers):
    tok, ttok = tokenizers
    rng = np.random.default_rng(6)
    mels = np.abs(rng.standard_normal((2, 41, tok.config.num_mels))).astype(
        np.float32)
    want = jax.jit(lambda v, x: BiCodec(tok.config).apply(
        v, x, method=lambda m, x: m.speaker_encoder.tokenize(x)))(
            tok.variables, jnp.asarray(mels))
    with torch.no_grad():
        got = ttok.model.speaker_encoder.tokenize(torch.as_tensor(mels))
    assert got.shape == (2, tok.config.token_num, 1)
    _assert_tokens_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1600, 5600])  # shorter / longer than 3200
def test_tokenizer_tokenize(tokenizers, n):
    """Global and semantic tokens exact, for a clip shorter than the 0.2-s
    reference segment (tiled) and one longer (cut)."""
    tok, ttok = tokenizers
    wav = _wav(n, seed=7)
    jg, js = tok.tokenize(jnp.asarray(wav))
    tg, ts = ttok.tokenize(torch.as_tensor(wav))
    assert tg.shape == jg.shape == (2, 1, tok.config.token_num)
    assert ts.shape == js.shape
    _assert_tokens_equal(tg.numpy(), jg)
    _assert_tokens_equal(ts.numpy(), js)
    np.testing.assert_allclose(
        ttok.extract_features(torch.as_tensor(wav)).numpy(),
        np.asarray(tok.extract_features(jnp.asarray(wav))), **TOL)


def test_decode_only_tokenizer_refuses_tokenize():
    cfg = t_bicodec.BiCodecConfig(**dataclasses.asdict(
        tiny_tokenizer_config()))
    with pytest.raises(RuntimeError):
        t_tok.BiCodecTokenizer(t_bicodec.BiCodec(cfg)).tokenize(
            torch.zeros(1, 3200))


def test_cli_loads_a_reference_bicodec_state_dict(tokenizers, tmp_path):
    """``--bicodec-ckpt``'s loader takes the whole reference state dict the
    JAX package exports (postnet and usage statistics included), and the
    tokenizer then gives JAX's tokens."""
    from unified_audio_tpu_torch import cli

    tok, ttok = tokenizers
    path = tmp_path / "bicodec.pt"
    torch.save(to_torch(export_bicodec_state_dict(
        jax.device_get(tok.variables), tok.config)), path)
    model = t_bicodec.BiCodec(ttok.config, tokenize=True)
    cli.load_bicodec(model, path)
    wav = _wav(4000, seed=12)
    tg, ts = t_tok.BiCodecTokenizer(model, ttok.ssl).eval().tokenize(
        torch.as_tensor(wav))
    jg, js = tok.tokenize(jnp.asarray(wav))
    _assert_tokens_equal(tg.numpy(), jg)
    _assert_tokens_equal(ts.numpy(), js)


def test_bicodec_converter_round_trip():
    """The port's ``bicodec_state_dict`` is, key for key and value for
    value, what the JAX package's ``export_bicodec_state_dict`` writes for
    the modules the tokenizing BiCodec builds (``bicodec_tokenizer_keys``
    drops the postnet and the usage statistics); the port loads it
    strictly, and the decode-side dict is its subset."""
    cfg = tiny_tokenizer_config()
    variables = bicodec_variables(cfg, seed=8)
    ours = t_convert.bicodec_state_dict(variables, cfg)
    ref = t_convert.bicodec_tokenizer_keys(
        export_bicodec_state_dict(variables, cfg))
    assert set(ours) == set(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    m = t_bicodec.BiCodec(t_bicodec.BiCodecConfig(**dataclasses.asdict(cfg)),
                          tokenize=True)
    m.load_state_dict(to_torch(ours))
    state = m.state_dict()
    assert set(state) - set(ours) <= {k for k in state
                                      if k.endswith("num_batches_tracked")}
    dec = t_convert.bicodec_decoder_state_dict(variables, cfg)
    assert set(dec) < set(ours)
