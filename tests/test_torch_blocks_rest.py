"""The SEANet-decoder family and the identity variants of the port
(``unified_audio_tpu_torch/nn/{recurrent,conv,blocks}.py``, ``ops/quant.py``,
``models/bicodec/speaker.py``) against the JAX package's, on the CPU, with
the weights carried by ``utils/convert.py``. Mirrors ``tests/test_blocks.py``
(the skip-LSTM, the sampling block up and down, the attention block, the
SEANet decoder's hop-320 shape) and ``tests/test_conv.py
TestSConvTranspose1d`` (the trim rule, causal and not), and adds HiFiGAN's
ResBlock1, the Vocos ResNet backbone, a BiCodec whose sampling blocks
resample (ratio 2) with the identity-projection FVQ and FSQ, and the
identity-context Perceiver. Floats within 1e-4, codes exactly equal."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_common import (TOL, bicodec_variables, random_variables,
                               tiny_bicodec_config, to_torch)
from unified_audio_tpu.nn import blocks as j_blocks
from unified_audio_tpu.nn import conv as j_conv
from unified_audio_tpu.nn import recurrent as j_rec
from unified_audio_tpu_torch.nn import blocks as t_blocks
from unified_audio_tpu_torch.nn import conv as t_conv
from unified_audio_tpu_torch.nn import recurrent as t_rec
from unified_audio_tpu_torch.utils import convert as t_convert


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jit(jm, method=None):
    """``jm.apply`` jitted: the larger stacks compile faster than they
    dispatch op by op."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=method))


def _run(tm, x):
    with torch.no_grad():
        return tm(torch.as_tensor(x)).numpy()


@pytest.mark.parametrize("skip", [True, False])
def test_slstm_equals_jax(skip):
    x = _x((2, 9, 8))
    jm = j_rec.SLSTM(dimension=8, num_layers=2, skip=skip)
    variables = random_variables(jm, x, seed=1)
    sd = {}
    t_convert._lstm(variables["params"]["lstm"], "lstm", sd)
    tm = t_rec.SLSTM(8, num_layers=2, skip=skip)
    tm.load_state_dict(to_torch(sd))
    got = _run(tm, x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)


@pytest.mark.parametrize("cin,cout,k,stride,causal,trim", [
    (8, 4, 16, 8, False, 1.0), (8, 4, 4, 2, True, 1.0),
    (8, 4, 10, 4, True, 0.5), (8, 4, 7, 3, False, 1.0)])
def test_sconv_transpose_equals_jax(cin, cout, k, stride, causal, trim):
    x = _x((2, 25, cin), 2)
    jm = j_conv.SConvTranspose1d(features=cout, kernel_size=k, stride=stride,
                                 causal=causal, trim_right_ratio=trim,
                                 weight_norm=False)
    variables = random_variables(jm, x, seed=3)
    sd = {}
    t_convert._convtr(variables["params"], "convtr.convtr", sd)
    tm = t_conv.SConvTranspose1d(cin, cout, k, stride, causal=causal,
                                 trim_right_ratio=trim)
    tm.load_state_dict(to_torch(sd))
    got = _run(tm, x)
    assert got.shape == (2, 25 * stride, cout)
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)


@pytest.mark.parametrize("up,down,t,want_t", [
    (2, 1, 50, 100), (1, 2, 50, 25), (3, 1, 50, 150), (1, 3, 48, 16),
    (1, 1, 50, 50)])
def test_sampling_block_equals_jax(up, down, t, want_t):
    """Up and down at ratios 2 and 3 (odd: an output pad of 1) and the
    ratio-1 pass; at ratio 3 down the frames are a multiple of 3, where the
    conv and the pools agree on the length (at 50 they do not, in JAX
    either)."""
    x = _x((2, t, 16), 4)
    jm = j_blocks.SamplingBlock(dim=16, groups=16, upsample_scale=up,
                                downsample_scale=down)
    variables = random_variables(jm, x, seed=5)
    tm = t_blocks.SamplingBlock(16, 16, up, down)
    tm.load_state_dict(to_torch(t_convert._unprefixed(
        t_convert._sampling, variables.get("params", {}))))
    got = _run(tm, x)
    assert got.shape == (2, want_t, 16)
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)


def test_attn_block_equals_jax():
    x = _x((2, 20, 64), 6)
    jm = j_blocks.AttnBlock(in_channels=64)
    variables = random_variables(jm, x, seed=7)
    tm = t_blocks.AttnBlock(64)
    tm.load_state_dict(to_torch(t_convert.attn_block_state_dict(variables)))
    got = _run(tm, x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)


@pytest.mark.parametrize("kw", [
    dict(lstm=1), dict(lstm=2, causal=True),
    dict(lstm=0, n_residual_layers=2, ratios=(4, 2), true_skip=True)],
    ids=["lstm1", "causal", "two_res_true_skip"])
def test_seanet_decoder_equals_jax(kw):
    """The decoder at hop prod(ratios) (320 for the default (8, 5, 4, 2)):
    equal to JAX with its weight norm folded."""
    z = _x((1, 10, 32), 8)
    jm = j_blocks.SEANetDecoder(dimension=32, n_filters=4, **kw)
    variables = random_variables(jm, z, seed=9)
    tm = t_blocks.SEANetDecoder(dimension=32, n_filters=4, **kw)
    tm.load_state_dict(to_torch(t_convert.seanet_decoder_state_dict(
        variables, kw.get("n_residual_layers", 1))))
    got = _run(tm, z)
    hop = int(np.prod(kw.get("ratios", (8, 5, 4, 2))))
    assert got.shape == (1, 10 * hop, 1)
    np.testing.assert_allclose(got, np.asarray(_jit(jm)(variables, z)), **TOL)


def test_seanet_decoder_weight_norm_kept():
    """``weight_norm=True`` with the (g, v) pairs kept by the bridge gives
    the folded decoder's output."""
    z = _x((1, 6, 32), 10)
    jm = j_blocks.SEANetDecoder(dimension=32, n_filters=4, lstm=1,
                                ratios=(4, 2))
    variables = random_variables(jm, z, seed=11)
    tm = t_blocks.SEANetDecoder(dimension=32, n_filters=4, lstm=1,
                                ratios=(4, 2), weight_norm=True)
    tm.load_state_dict(to_torch(t_convert.seanet_decoder_state_dict(
        variables, unfold=True)))
    assert any(k.endswith("weight_g") for k in tm.state_dict())
    np.testing.assert_allclose(_run(tm, z), np.asarray(_jit(jm)(variables,
                                                                 z)), **TOL)


@pytest.mark.parametrize("scale", [None, 0.1])
def test_resblock1_equals_jax(scale):
    x = _x((2, 30, 16), 12)
    jm = j_blocks.ResBlock1(dim=16, layer_scale_init_value=scale)
    variables = random_variables(jm, x, seed=13)
    tm = t_blocks.ResBlock1(16, layer_scale_init_value=scale)
    tm.load_state_dict(to_torch(t_convert.resblock1_state_dict(variables)))
    np.testing.assert_allclose(_run(tm, x), np.asarray(jm.apply(variables, x)),
                               **TOL)


def test_vocos_resnet_backbone_equals_jax():
    x = _x((2, 30, 12), 14)
    jm = j_blocks.VocosResNetBackbone(dim=16, num_blocks=2)
    variables = random_variables(jm, x, seed=15)
    tm = t_blocks.VocosResNetBackbone(12, 16, 2)
    tm.load_state_dict(to_torch(t_convert.vocos_resnet_state_dict(variables)))
    got = _run(tm, x)
    assert got.shape == (2, 30, 16)
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)


def test_bicodec_resampling_and_identity_quantizers_equal_jax():
    """A BiCodec whose feature encoder halves the frame rate and whose
    prenet doubles it again (sampling ratio 2), with ``latent_dim ==
    codebook_dim`` (FVQ without projections) and ``spk_latent_dim ==
    len(fsq_levels)`` (FSQ without projections): tokens exactly JAX's,
    the waveform within 1e-4."""
    from unified_audio_tpu.models.bicodec.bicodec import BiCodec
    from unified_audio_tpu_torch.models.bicodec import bicodec as t_bicodec

    cfg = dataclasses.replace(tiny_bicodec_config(), sample_ratios=(2, 1),
                              codebook_dim=32, spk_latent_dim=3)
    variables = jax.device_get(bicodec_variables(cfg))
    assert "in_project" not in variables["params"]["quantizer"]
    tm = t_bicodec.BiCodec(t_bicodec.BiCodecConfig(
        **dataclasses.asdict(cfg)), tokenize=True)
    tm.load_state_dict(to_torch(t_convert.bicodec_state_dict(variables,
                                                             cfg)))
    tm.eval()
    feat = _x((1, 20, cfg.feat_dim), 16)
    wav = 0.1 * _x((1, cfg.latent_hop_length * 10), 17)
    jm = BiCodec(cfg)
    js, jg = _jit(jm, "tokenize")(variables, feat, wav)
    with torch.no_grad():
        ts, tg = tm.tokenize(torch.as_tensor(feat), torch.as_tensor(wav))
    assert ts.shape == (1, 10)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    want = _jit(jm, "detokenize")(variables, js, jg)
    with torch.no_grad():
        got = tm.detokenize(ts, tg).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_perceiver_identity_context_equals_jax():
    from unified_audio_tpu.models.bicodec.speaker import PerceiverResampler
    from unified_audio_tpu_torch.models.bicodec import speaker as t_speaker

    x = _x((2, 7, 16), 18)
    jm = PerceiverResampler(dim=16, dim_context=16, num_latents=4, depth=1,
                            dim_head=8, heads=2)
    variables = random_variables(jm, x, seed=19)
    assert "proj_context" not in variables["params"]
    tm = t_speaker.PerceiverResampler(16, 16, num_latents=4, depth=1,
                                      dim_head=8, heads=2)
    tm.load_state_dict(to_torch(t_convert._unprefixed(
        t_convert._perceiver, variables["params"])))
    got = _run(tm, x)
    assert got.shape == (2, 4, 16)
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)
