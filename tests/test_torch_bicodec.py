"""Port vs JAX: BiCodec's decode side (FVQ detokenize, residual-FSQ decode with
the channel-major flatten, the prenet, the DAC wave generator), the FVQ's
``decode_latents`` and the speaker branch's TAP/TSDP/TSTP pooling heads, on a
tiny configuration with seeded weights whose waveform stays out of tanh
saturation. Tolerance: atol/rtol 1e-4 (different reduction order); FSQ codes
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (TOL, bicodec_decoder_variables, port_bicodec,
                               tiny_bicodec_config)
from unified_audio_tpu.models.bicodec.bicodec import BiCodec
from unified_audio_tpu.ops import quant as j_quant
from unified_audio_tpu_torch.ops import quant as t_quant


@pytest.fixture(scope="module")
def codec():
    cfg = tiny_bicodec_config()
    variables = bicodec_decoder_variables(cfg)
    return cfg, BiCodec(cfg), variables, port_bicodec(cfg, variables)


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    sem = rng.integers(0, cfg.codebook_size, (2, 7)).astype(np.int32)
    glob = rng.integers(0, 4 ** len(cfg.fsq_levels),
                        (2, cfg.token_num, 1)).astype(np.int32)
    return sem, glob


def test_fsq_indices_to_codes():
    idx = np.arange(64, dtype=np.int32).reshape(4, 16)
    want = j_quant.FSQ(levels=(4, 4, 4)).apply({}, jnp.asarray(idx),
                                               method="indices_to_codes")
    got = t_quant.FSQ((4, 4, 4)).indices_to_codes(torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantizer_and_speaker_decode(codec):
    cfg, model, variables, tm = codec
    sem, glob = _tokens(cfg, 1)
    jz = model.apply(variables, jnp.asarray(sem),
                     method=lambda m, s: m.quantizer.detokenize(s))
    jd = model.apply(variables, jnp.asarray(glob),
                     method=lambda m, g: m.speaker_encoder.detokenize(g))
    with torch.no_grad():
        tz = tm.quantizer.detokenize(torch.as_tensor(sem))
        td = tm.speaker_encoder.detokenize(torch.as_tensor(glob))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


def test_detokenize_waveform(codec):
    cfg, model, variables, tm = codec
    sem, glob = _tokens(cfg, 2)
    want = jax.jit(lambda v, s, g: model.apply(v, s, g, method="detokenize"))(
        variables, jnp.asarray(sem), jnp.asarray(glob))
    with torch.no_grad():
        got = tm.detokenize(torch.as_tensor(sem), torch.as_tensor(glob))
    assert got.shape == want.shape == (2, 7 * 320)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["tap_pool", "tsdp_pool", "tstp_pool"])
def test_pooling_heads_match_jax(name):
    """The reference's TAP, TSDP and TSTP heads on (B, T, C) features."""
    from unified_audio_tpu.models.bicodec import speaker as j_speaker
    from unified_audio_tpu_torch.models.bicodec import speaker as t_speaker

    x = np.random.default_rng(7).standard_normal((3, 50, 32)).astype(
        np.float32)
    x[2] = 0.25  # a constant row: the std is the 1e-7 floor's root
    want = np.asarray(getattr(j_speaker, name)(jnp.asarray(x)))
    got = getattr(t_speaker, name)(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_fvq_decode_latents_matches_jax():
    """The cosine search on projected latents: indices equal, rows equal;
    ``tokenize`` goes through it."""
    rng = np.random.default_rng(8)
    cb = rng.standard_normal((64, 8)).astype(np.float32)
    z_e = rng.standard_normal((2, 9, 8)).astype(np.float32)
    fvq = j_quant.FactorizedVectorQuantize(input_dim=8, codebook_size=64,
                                           codebook_dim=8)
    variables = {"params": {"codebook": jnp.asarray(cb)},
                 "codebook": {"cluster_size": jnp.zeros((64,))}}
    want_q, want_i = fvq.apply(variables, jnp.asarray(z_e),
                               method="decode_latents")
    port = t_quant.FactorizedVectorQuantize(8, 64, 8, tokenize=True)
    port.codebook.weight.data = torch.as_tensor(cb)
    got_q, got_i = port.decode_latents(torch.as_tensor(z_e))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_q.detach().numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(port.tokenize(torch.as_tensor(z_e)),
                                  got_i)
