"""Port vs JAX: BiCodec's decode side (FVQ detokenize, residual-FSQ decode
with the channel-major flatten, the prenet, the DAC wave generator) on a
tiny configuration with seeded weights whose waveform stays out of tanh
saturation. Tolerance: atol/rtol 1e-4 (different reduction order); FSQ
codes exactly.
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
