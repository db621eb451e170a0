"""HCodec's bf16 serving mode (``HCodecTokenizer(..., dtype=torch.bfloat16)``,
``cli codec --dtype bfloat16``) against the port's fp32 path and the JAX
package's bf16 mode, at the tiny ``small10()`` and ``small20()`` configs
with their codebooks k-means-initialized by one training pass, as
tests/test_hcodec.py's bf16 test does.

Measured here (the CPU, torch 2.13): bf16 codes agree with the fp32 codes
on 128 of 128 (1.0) and 63 of 64 (2.0); with JAX's bf16 codes on 128 of 128
(1.0: JAX's bf16 tokenize of HCodec-2.0 raises in its STFT, which takes no
bf16, so 2.0 has no JAX codes to compare); decoding the same codes, bf16
against JAX's bf16 34.2 / 34.8 dB and against fp32 35.3 / 35.8 dB. Over
seeds 4-6 of the weights the agreement with fp32 ran 0.92-1.0.

Floors: agreement with fp32 0.75 (JAX's bound), with JAX's bf16 0.95; the
SNR 15 dB (JAX's bound). The codes of the bf16 path are, exactly, the plain
search on the fp32 values of its bf16 latents and codebooks (K6's fp32
island). The port keeps the residual between VQ layers in fp32 where JAX
rounds it to bf16; the two agree exactly on the first layer here.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hcodec import _wav, port_tokenizer, seeded_models, small10, \
    small20
from unified_audio_tpu.models.hcodec.tokenizer import HCodecTokenizer
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav
from unified_audio_tpu_torch.models.hcodec import codec as t_codec
from unified_audio_tpu_torch.models.hcodec.tokenizer import (
    HCodecTokenizer as THCodecTokenizer)
from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl
from unified_audio_tpu_torch.nn import transformer as t_tf
from unified_audio_tpu_torch.nn.heads import ISTFTHead
from unified_audio_tpu_torch.nn.recurrent import LSTM
from unified_audio_tpu_torch.ops.cuda import vq
from unified_audio_tpu_torch.utils import convert as t_convert
from unified_audio_tpu_torch.utils.precision import cast_floating

LENGTHS = {"1.0": 640 * 32, "2.0": 3840 * 16}


def _snr(got, want):
    return 10 * np.log10(np.mean(want ** 2) / np.mean((got - want) ** 2))


@functools.lru_cache(maxsize=None)
def _models(version):
    """JAX variables with k-means-initialized codebooks (one training
    pass on the clip), the JAX fp32 and bf16 tokenizers, the port's fp32
    and bf16 tokenizers, the clip."""
    cfg = small10() if version == "1.0" else small20()
    n = LENGTHS[version]
    cfg, ssl_cfg, variables, ssl_vars, jtok, _ = seeded_models(cfg, n)
    x = jnp.asarray(_wav(14, n, cfg.sample_rate))
    _, mut = jtok.codec.apply(
        variables, x[..., None], jtok.extract_features(x), train=True,
        mutable=["codebook"], rngs={"quant": jax.random.PRNGKey(3)})
    variables = jax.device_get({**variables, "codebook": mut["codebook"]})
    j32 = HCodecTokenizer(cfg, variables, ssl_cfg, ssl_vars)
    j16 = HCodecTokenizer(cfg, variables, ssl_cfg, ssl_vars,
                          dtype=jnp.bfloat16)
    t32 = port_tokenizer(cfg, variables, ssl_cfg, ssl_vars)
    t16 = port_tokenizer(cfg, variables, ssl_cfg, ssl_vars)
    t16 = THCodecTokenizer(t16.codec, t16.ssl, dtype=torch.bfloat16)
    return cfg, ssl_cfg, variables, j32, j16, t32, t16, np.asarray(x)


@functools.lru_cache(maxsize=None)
def _codes(version):
    *_, t32, t16, x = _models(version)
    wav = torch.as_tensor(x)
    return t32.tokenize(wav), t16.tokenize(wav)


def _agreement(a, b):
    return float(np.mean(np.concatenate(
        [(np.asarray(p) == np.asarray(q)).ravel() for p, q in zip(a, b)])))


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_bf16_codes_agree_with_fp32(version):
    fp32, bf16 = _codes(version)
    assert bf16[0].dtype == torch.int32
    assert _agreement(fp32, bf16) >= 0.75


def test_bf16_codes_agree_with_jax_bf16():
    *_, j16, _, _, x = _models("1.0")
    _, bf16 = _codes("1.0")
    want = j16.tokenize(jnp.asarray(x))
    assert _agreement(bf16, want) >= 0.95


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_bf16_codes_are_the_plain_search_on_fp32_latents(version):
    """The bf16 path's codes are K6's plain version on the fp32 values of
    its bf16 latents and bf16 codebooks, residual in fp32."""
    *_, t16, x = _models(version)
    _, bf16 = _codes(version)
    latents = t16.latents(torch.as_tensor(x))
    for lat, rvq, codes in zip(latents, (t16.codec.quantizer,
                                         t16.codec.semantic_quantizer),
                               bf16):
        assert lat.dtype == torch.bfloat16
        books = rvq.codebooks()
        assert all(cb.dtype == torch.bfloat16 for cb in books)
        want = vq.rvq_encode_fused_ref(
            lat.reshape(-1, lat.shape[-1]).float(),
            [cb.float() for cb in books])
        np.testing.assert_array_equal(
            codes.transpose(-1, -2).reshape(-1, len(books)).numpy(),
            want.numpy())


def test_fp32_residual_against_jax_bf16_residual():
    """JAX's bf16 encode rounds the residual to bf16 after each layer, the
    port's K6 keeps it fp32 (the one deviation of the bf16 mode): on the
    same bf16 latents and codebooks the first layer agrees exactly and the
    rest mostly."""
    cfg, _, _, _, j16, _, t16, x = _models("1.0")
    latents = t16.latents(torch.as_tensor(x))
    for name, lat in zip(("quantizer", "semantic_quantizer"), latents):
        port = getattr(t16.codec, name).encode(lat).numpy()
        want = np.asarray(j16.codec.apply(
            j16.codec_variables,
            jnp.asarray(lat.float().numpy()).astype(jnp.bfloat16),
            method=lambda m, z: getattr(m, name).encode(z)))
        np.testing.assert_array_equal(port[..., 0], want[..., 0])
        assert np.mean(port == want) >= 0.75


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_bf16_decode_snr(version):
    """The same codes decoded in bf16 stay within bf16 rounding of JAX's
    bf16 decode and of the port's fp32 decode, and come out fp32."""
    *_, j16, t32, t16, _ = _models(version)
    (ac, sem), _ = _codes(version)
    got = t16.detokenize(ac, sem)
    assert got.dtype == torch.float32
    got = got.numpy()
    want16 = np.asarray(j16.detokenize(jnp.asarray(ac.numpy()),
                                       jnp.asarray(sem.numpy())))
    assert want16.dtype == np.float32
    assert _snr(got, want16) > 15.0
    assert _snr(got, t32.detokenize(ac, sem).numpy()) > 15.0


def test_cast_keeps_ints_and_casts_every_floating_buffer():
    *_, t16, _ = _models("1.0")
    for name, t in list(t16.codec.state_dict().items()) + list(
            t16.ssl.state_dict().items()):
        assert t.dtype == torch.bfloat16, name
    m = torch.nn.Module()
    m.register_buffer("ids", torch.arange(3))
    m.register_buffer("flag", torch.ones(2, dtype=torch.bool))
    cast_floating(m)
    assert m.ids.dtype == torch.int64 and m.flag.dtype == torch.bool


def test_bf16_module_numerics():
    """RoPE keeps q/k's bf16 (fp32 tables), attention and the hybrid
    transformer stay bf16, norm statistics are fp32 inside (the bf16
    output is the fp32 norm of the same values, rounded), the LSTM runs
    bf16 and the ISTFT head stays an fp32 island."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 12, 64, generator=g)
    cos, sin = t_tf.rope_cos_sin(torch.arange(12), 16)
    q, k = t_tf.apply_rope(x.view(2, 12, 4, 16).bfloat16(),
                           x.view(2, 12, 4, 16).bfloat16(), cos, sin)
    assert q.dtype == k.dtype == torch.bfloat16 and cos.dtype == torch.float32
    tf = cast_floating(t_tf.Transformer(64, 128, 4, 2))
    assert tf(x.bfloat16()).dtype == torch.bfloat16

    for norm in (torch.nn.LayerNorm(64), torch.nn.GroupNorm(8, 64),
                 t_tf.RMSNorm(64)):
        for p in norm.parameters():
            torch.nn.init.normal_(p, 1.0, 0.1, generator=g)
        inp = (3.0 + x).bfloat16()
        inp = inp.transpose(1, 2) if isinstance(norm, torch.nn.GroupNorm) \
            else inp
        want = norm(inp.float())
        cast_floating(norm)
        got = norm(inp)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.bfloat16().float(),
                                   rtol=1e-2, atol=1e-2)

    lstm = cast_floating(LSTM(64, 32))
    assert lstm(x.bfloat16()).dtype == torch.bfloat16
    head = cast_floating(ISTFTHead(64, 64, 16))
    assert head(x.bfloat16()).dtype == torch.float32


def test_hubert_bf16_against_jax_bf16():
    """HuBERT cast to bf16 (group norm, layer norms and the grouped
    positional conv in bf16, statistics fp32): its features stay within
    bf16 rounding of JAX's bf16 HuBERT on the same wav."""
    *_, j16, t32, t16, x = _models("1.0")
    got = t16.extract_features(torch.as_tensor(x))
    assert got.dtype == torch.bfloat16
    want = np.asarray(j16.extract_features(jnp.asarray(x))).astype(
        np.float32)
    err = np.sqrt(np.mean((got.float().numpy() - want) ** 2)
                  / np.mean(want ** 2))
    assert err < 0.05, err


@pytest.mark.parametrize("model", ["hcodec10", "hcodec20"])
def test_cli_codec_bf16(model, tmp_path, monkeypatch, capsys):
    """``cli codec --dtype bfloat16`` with ``--ckpt``: the codec is cast
    after the weights load, the wav comes out finite at the input's
    length, and the codes agree with the fp32 run."""
    version = "1.0" if model == "hcodec10" else "2.0"
    cfg, ssl_cfg, variables, *_ = _models(version)
    monkeypatch.setattr(cli, "_build_hcodec", functools.partial(
        cli._build_hcodec, cfg=t_codec.HCodecConfig(
            **dataclasses.asdict(cfg)),
        ssl_cfg=t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg))))
    export = (t_convert.hcodec10_state_dict if version == "1.0"
              else t_convert.hcodec20_state_dict)
    ckpt = tmp_path / "codec.pt"
    torch.save({k: torch.as_tensor(np.ascontiguousarray(v))
                for k, v in export(variables, cfg).items()}, ckpt)
    n = LENGTHS[version] // 4
    write_wav(tmp_path / "in.wav", _wav(3, n, cfg.sample_rate)[0],
              cfg.sample_rate)
    codes, dtypes = [], []
    encode = t_codec.HCodec.encode

    def recording(self, wav, feat):
        dtypes.append((wav.dtype, feat.dtype, self.quantizer.codebooks()[
            0].dtype))
        codes.append(encode(self, wav, feat))
        return codes[-1]

    monkeypatch.setattr(t_codec.HCodec, "encode", recording)
    for dtype in ("float32", "bfloat16"):
        cli.main(["codec", "--model", model, "--input",
                  str(tmp_path / "in.wav"), "--output",
                  str(tmp_path / f"{dtype}.wav"), "--ckpt", str(ckpt),
                  "--dtype", dtype, "--device", "cpu"])
        out, fs = read_wav(tmp_path / f"{dtype}.wav")
        assert fs == cfg.sample_rate and out.shape == (1, n)
        assert np.isfinite(out).all()
    assert dtypes[0] == (torch.float32,) * 3
    assert dtypes[1] == (torch.bfloat16,) * 3
    assert _agreement(codes[0], codes[1]) >= 0.75
