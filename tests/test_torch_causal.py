"""The causal HCodec of the port (``unified_audio_tpu_torch``) against the
JAX package on the CPU, at tiny sizes: the causal conv primitives (the
constant-pad conv with dilation and stride, the EnCodec reflect conv, the
sub-pixel upsampler), blocks and stacks, the causal encoders and the causal
HCodec-1.0 and 2.0 tokenize/detokenize; the causality of the SEANet
encoder and the ConvNeXt stack, and the reference's non-causal
``PriorNet``. The training forwards and ``cli train-codec`` are in
``tests/test_torch_causal_train.py``, the causal HCodec-1.5 and FlexiCodec
in ``tests/test_torch_causal_codecs.py``.

Tolerances: codes and token ids exact; floats within atol/rtol 1e-4
(waveforms within 1e-4 of their peak).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables
from test_torch_hcodec import L, L20, _wav, seeded_models, small10, small20
from unified_audio_tpu.models.hcodec import codec as j_codec
from unified_audio_tpu.nn import blocks as j_blocks
from unified_audio_tpu.nn import conv as j_conv
from unified_audio_tpu_torch.models.hcodec import codec as t_codec
from unified_audio_tpu_torch.nn import blocks as t_blocks
from unified_audio_tpu_torch.nn import conv as t_conv
from unified_audio_tpu_torch.utils import convert as t_convert
from unified_audio_tpu_torch.utils.initialization import init_random_


def causal10():
    return dataclasses.replace(small10(), causal=True)


def causal20():
    return dataclasses.replace(small20(), causal=True)


def _load(module, sd):
    module.load_state_dict({k: torch.as_tensor(np.array(v))
                            for k, v in sd.items()})
    return module.eval()


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# Conv primitives, blocks and stacks
# ---------------------------------------------------------------------------

def _constant(kw):
    def build():
        jm = j_conv.CausalConv1d(4, 5, causal=True, **kw)
        tm = t_conv.CausalConv1d(6, 4, 5, causal=True, **kw)
        return jm, tm, lambda p, out: t_convert._hconv(p, "", out)
    return build


def _reflect(stride, kernel):
    def build():
        jm = j_conv.SConv1d(4, kernel, stride=stride, causal=True)
        tm = t_conv.SConv1d(6, 4, kernel, stride=stride, weight_norm=True,
                            causal=True)
        return jm, tm, lambda p, out: t_convert._sconv(p, "", out, True)
    return build


def _subpixel():
    jm = j_conv.SubPixelConvTranspose1d(4, 5, stride=2, causal=True)
    tm = t_conv.SubPixelConvTranspose1d(6, 4, 5, stride=2, causal=True)

    def convert(p, out):
        out["up.weight"] = np.asarray(p["up_kernel"]).transpose(2, 1, 0)
        out["up.bias"] = np.asarray(p["up_bias"])
        out["dw.weight"] = np.asarray(p["dw_kernel"]).transpose(2, 1, 0)
        out["dw.bias"] = np.asarray(p["bias"])
    return jm, tm, convert


@pytest.mark.parametrize("build", [
    _constant(dict(dilation=2)), _constant(dict(stride=2)),
    _constant(dict(dilation=3, stride=2)), _reflect(1, 3), _reflect(2, 4),
    _reflect(4, 8), _subpixel],
    ids=["constant_d2", "constant_s2", "constant_d3_s2", "reflect_k3",
         "reflect_k4_s2", "reflect_k8_s4", "subpixel_s2"])
@pytest.mark.parametrize("length", [3, 11])
def test_causal_conv(build, length):
    """Each causal conv of the JAX package (constant zeros (dk - stride, 0)
    with dk the dilated span; reflect (K - stride, extra), an input of 3
    samples shorter than the pad; the sub-pixel upsampler's (K - 1, 0))
    within 1e-4, weight norm kept as (g, v) for the reflect conv."""
    jm, tm, convert = build()
    x = np.random.default_rng(length).standard_normal(
        (2, length, 6)).astype(np.float32)
    variables = random_variables(jm, x, seed=length)
    sd = {}
    convert(variables["params"], sd)
    _load(tm, {k.lstrip("."): v for k, v in sd.items()})
    want = jm.apply(variables, x)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    assert got.shape == want.shape
    _close(got, want)


def _convnext():
    jm = j_blocks.ConvNeXtStack(16, 32, 2, causal=True,
                                layer_scale_init_value=0.5)
    tm = t_blocks.ConvNeXtStack(16, 32, 2, causal=True)
    return jm, tm, lambda p, out: t_convert._convnext_stack(p, "", out), 16


def _resnet():
    jm = j_blocks.ResnetBlock(32, causal=True)
    tm = t_blocks.ResnetBlock(32, causal=True)
    return jm, tm, lambda p, out: t_convert._resnet_block(p, "", out), 32


def _prior():
    jm = j_codec.PriorNet(64, causal=True)
    tm = t_codec.PriorNet(64, causal=True)
    return jm, tm, lambda p, out: t_convert._prior_net(p, "", out), 64


def _decoder10():
    jm = j_codec.CodecDecoder10(dim=64, intermediate_dim=128,
                                convnext_layers=2, causal=True)
    tm = t_codec.CodecDecoder10(32, 64, 128, 2, causal=True)
    return (jm, tm, lambda p, out: t_convert._codec_decoder10(p, "", out),
            32)


@pytest.mark.parametrize("build", [_convnext, _resnet, _prior, _decoder10],
                         ids=["convnext_stack", "resnet_block", "prior_net",
                              "codec_decoder10"])
def test_causal_block(build):
    """The causal ConvNeXt stack (the k7 depthwise conv padded (6, 0)), the
    causal GroupNorm resnet block, the prior net (its transformer under
    the causal mask) and HCodec-1.0's decoder within 1e-4 of JAX's."""
    jm, tm, convert, width = build()
    x = np.random.default_rng(width).standard_normal(
        (2, 9, width)).astype(np.float32)
    variables = random_variables(jm, x, seed=width)
    sd = {}
    convert(variables["params"], sd)
    _load(tm, {k.lstrip("."): v for k, v in sd.items()})
    want = jm.apply(variables, x)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    assert got.shape == want.shape
    if got.dim() == 2:  # a waveform: within 1e-4 of its peak
        assert np.abs(got.numpy() - np.asarray(want)).max() <= \
            1e-4 * np.abs(np.asarray(want)).max()
    else:
        _close(got, want)


# ---------------------------------------------------------------------------
# HCodec-1.0 and 2.0
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["hcodec10", "hcodec20"])
def causal_models(request):
    if request.param == "hcodec10":
        return seeded_models(causal10(), L), L, 16000
    return seeded_models(causal20(), L20), L20, 48000


def test_causal_encoder(causal_models):
    """The causal SEANet encoder (1.0; weight norm folded) or STFT encoder
    (2.0) within 1e-4 of JAX's."""
    (cfg, _, variables, _, _, tok), length, sr = causal_models
    x = _wav(30, length, sr)
    if cfg.version == "1.0":
        jm = j_blocks.SEANetEncoder(
            dimension=cfg.latent_dim, n_filters=cfg.seanet_filters,
            ratios=cfg.seanet_ratios, causal=True)
        x = x[..., None]
    else:
        jm = j_codec.CodecEncoder20(
            dim=cfg.encoder_dim, intermediate_dim=cfg.encoder_intermediate_dim,
            dimension=cfg.latent_dim, n_fft=cfg.n_fft,
            hop_length=cfg.istft_hop,
            convnext_layers=cfg.encoder_convnext_layers, causal=True)
    want = jm.apply({"params": variables["params"]["encoder"]}, x)
    with torch.no_grad():
        got = tok.codec.encoder(torch.as_tensor(x))
    _close(got, want)


def test_causal_round_trip(causal_models):
    """``HCodecTokenizer`` over a causal HCodec: codes equal JAX's exactly,
    the waveform of those codes within 1e-4 of its peak."""
    (cfg, _, _, _, jtok, tok), length, sr = causal_models
    assert tok.codec.config.causal
    wav = _wav(31, length - 100, sr)
    jac, jsem = jtok.tokenize(jnp.asarray(wav))
    ac, sem = tok.tokenize(torch.as_tensor(wav))
    np.testing.assert_array_equal(ac.numpy(), np.asarray(jac))
    np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem))
    assert len(np.unique(np.asarray(jac))) > 3, "degenerate codes"
    want = np.asarray(jtok.detokenize(jac, jsem))
    got = tok.detokenize(ac, sem).numpy()
    assert got.shape == want.shape == (1, length)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Causality
# ---------------------------------------------------------------------------

def _perturbed(fn, x, start):
    """fn(x) and fn of x with every sample from ``start`` on replaced."""
    y = x.clone()
    y[:, start:] = torch.randn_like(y[:, start:])
    with torch.no_grad():
        return fn(x), fn(y)


def test_seanet_encoder_is_causal():
    """The causal SEANet encoder (hop 640): samples from 4000 on moved,
    frames 0-5 (which end at sample 3839) stay within 1e-6, and frames 6 on
    change."""
    enc = init_random_(t_blocks.SEANetEncoder(64, 4, causal=True),
                       torch.Generator().manual_seed(0))
    torch.manual_seed(0)
    x = torch.randn(1, 6400, 1)
    a, b = _perturbed(enc, x, 4000)
    assert a.shape == (1, 10, 64)
    diff = (a - b).abs().amax(-1)[0]
    assert diff[:6].max() <= 1e-6 and (diff[6:] > 1e-3).all(), diff


def test_convnext_stack_is_causal():
    """The causal ConvNeXt stack: frames from 20 on moved, frames 0-19
    exactly as before, and frame 20 on change."""
    stack = init_random_(t_blocks.ConvNeXtStack(16, 32, 3, causal=True),
                         torch.Generator().manual_seed(1))
    torch.manual_seed(1)
    x = torch.randn(2, 32, 16)
    a, b = _perturbed(stack, x, 20)
    diff = (a - b).abs().amax(-1)
    assert diff[:, :20].max() == 0.0 and (diff[:, 20:] > 0).all()


def test_prior_net_is_not_causal_as_in_jax():
    """The reference's causal ``PriorNet`` is not causal end to end: its
    GroupNorms take statistics over the whole clip. Moving frames 30 on
    moves frames 0-29, in the JAX package and in the port alike (the port
    copies it; ROADMAP's reference hazards)."""
    jm, tm, convert, width = _prior()
    x = np.random.default_rng(7).standard_normal((1, 40, 64)).astype(
        np.float32)
    y = x.copy()
    y[:, 30:] = np.random.default_rng(8).standard_normal((1, 10, 64))
    variables = random_variables(jm, x, seed=9)
    sd = {}
    convert(variables["params"], sd)
    _load(tm, {k.lstrip("."): v for k, v in sd.items()})
    jd = np.abs(np.asarray(jm.apply(variables, x))
                - np.asarray(jm.apply(variables, y)))[0, :30].max()
    with torch.no_grad():
        td = (tm(torch.as_tensor(x)) - tm(torch.as_tensor(y))).abs()[
            0, :30].max().item()
    assert jd > 1e-3 and td > 1e-3
    assert abs(jd - td) <= 1e-4 * max(jd, 1.0)
