"""FlexiCodec of the port (``unified_audio_tpu_torch``) against the JAX
package on the CPU, at a tiny configuration (a 4-wide DAC encoder to a
32-wide latent, 2 x 32 codes of dimension 4, a 16-wide semantic adapter,
FSQ levels (4, 4, 4)): the DAC encoder and decoder, the projected cosine
RVQ, the vendored FSQ, the codec's encode/decode in the DualCodec mode and
in the aligned mode (similarity groups, query-token aggregators, the Mimi
bottleneck), the semantic-stream helpers and ``cli codec --model
flexicodec`` with each of its three semantic streams.

Weights are the JAX package's seeded variables carried over by its own
``export_flexicodec_state_dict``. Tolerances: codes, FSQ indices and group
lengths exact; features and waveforms within atol/rtol 1e-4 (waveforms
within 1e-4 of their peak, plus one 16-bit step for wav files).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables, to_torch
from test_torch_sanm import (funasr_state_dict, sanm_variables,
                             tiny_sanm_config, write_cmvn)
from unified_audio_tpu.models.hcodec import flexicodec as j_flexi
from unified_audio_tpu.models.ssl import sanm as j_sanm
from unified_audio_tpu.nn.blocks import WaveGenerator as JWaveGenerator
from unified_audio_tpu.utils.convert_hcodec import export_flexicodec_state_dict
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav
from unified_audio_tpu_torch.models.hcodec import flexicodec as t_flexi
from unified_audio_tpu_torch.models.ssl import sanm as t_sanm
from unified_audio_tpu_torch.utils import convert as t_convert

T = 8  # acoustic frames
HOP = 512
PCM_STEP = 2.0 ** -15


def tiny_cfg(**kw):
    base = dict(
        sample_rate=16000, encoder_dim=4, encoder_rates=(2, 4, 8, 8),
        latent_dim=32, decoder_dim=32, decoder_rates=(8, 8, 4, 2),
        n_codebooks=2, codebook_size=32, codebook_dim=4, ssl_dim=32,
        convnext_dim=16, convnext_layers=2, fsq_levels=(4, 4, 4),
        agg_layers=1, agg_ff=64, bottleneck_layers=1, bottleneck_ff=64,
        max_tokens_per_group=4)
    base.update(kw)
    return j_flexi.FlexiCodecConfig(**base)


def aligned_cfg(**kw):
    return tiny_cfg(use_similarity_alignment=True,
                    use_query_token_aggregator=True,
                    use_bottleneck_transformer=True, **kw)


def port_cfg(cfg):
    return t_flexi.FlexiCodecConfig(**dataclasses.asdict(cfg))


def port_model(cfg, variables):
    m = t_flexi.FlexiCodec(port_cfg(cfg))
    m.load_state_dict(to_torch(t_convert.flexicodec_inference_keys(
        export_flexicodec_state_dict(variables, cfg))))
    return m.eval()


def _inputs(seed, t=T, ssl_dim=32):
    rng = np.random.default_rng(seed)
    tt = np.arange(HOP * t) / 16000
    wav = (0.4 * np.sin(2 * np.pi * 200 * tt)
           + 0.1 * rng.standard_normal(HOP * t)).astype(np.float32)[None]
    sem = rng.standard_normal((1, 2 * t, ssl_dim)).astype(np.float32)
    sem[:, 1:] += sem[:, :-1]  # neighbours alike: groups of several frames
    return wav, sem


def _seeded(cfg, seed):
    wav, sem = _inputs(0)
    jm = j_flexi.FlexiCodec(cfg)
    variables = jax.device_get(random_variables(jm, wav, sem, seed=seed,
                                                out_gain=0.05))
    return cfg, variables, jm, port_model(cfg, variables)


@pytest.fixture(scope="module")
def dual():
    return _seeded(tiny_cfg(), 1)


@pytest.fixture(scope="module")
def aligned():
    return _seeded(aligned_cfg(), 2)


def _peak_close(got, want, extra=0.0):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + extra


class TestModules:
    def test_dac_encoder(self, dual):
        cfg, variables, _, port = dual
        wav = _inputs(3)[0][..., None]
        want = j_flexi.DACEncoder(cfg.encoder_dim, cfg.encoder_rates,
                                  cfg.latent_dim).apply(
            {"params": variables["params"]["encoder"]}, wav)
        with torch.no_grad():
            got = port.dac.encoder(torch.as_tensor(wav))
        assert got.shape == (1, T, cfg.latent_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_dac_decoder(self, dual):
        cfg, variables, _, port = dual
        z = np.random.default_rng(4).standard_normal(
            (1, T, cfg.latent_dim)).astype(np.float32)
        want = JWaveGenerator(
            input_channel=cfg.latent_dim, channels=cfg.decoder_dim,
            rates=cfg.decoder_rates,
            kernel_sizes=tuple(2 * r for r in cfg.decoder_rates)).apply(
                {"params": variables["params"]["decoder"]}, z)
        with torch.no_grad():
            got = port.dac.decoder(torch.as_tensor(z))
        assert got.shape == (1, T * HOP, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_dac_rvq_codes(self, dual):
        """Codes equal JAX's exactly (the smallest gap between a row's best
        and second-best first-layer distance in the message); the decoded
        latents within 1e-4."""
        cfg, variables, _, port = dual
        z = np.random.default_rng(5).standard_normal(
            (2, 40, cfg.latent_dim)).astype(np.float32)
        jq = j_flexi.DACRVQ(cfg.latent_dim, cfg.n_codebooks,
                            cfg.codebook_size, cfg.codebook_dim)
        qv = {"params": variables["params"]["quantizer"]}
        want = np.asarray(jq.apply(qv, z, method="encode"))
        q = port.dac.quantizer
        with torch.no_grad():
            got = q.encode(torch.as_tensor(z))
            z_e = q.quantizers[0].in_proj(torch.as_tensor(z))
            enc = z_e / z_e.norm(dim=-1, keepdim=True)
            cb = q.quantizers[0].codebook.weight
            sims = (enc @ (cb / cb.norm(dim=-1, keepdim=True)).T).sort(
                -1).values
        gap = float((sims[..., -1] - sims[..., -2]).min())
        assert got.dtype == torch.int32 and got.shape == (2, 40, 2)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"smallest gap {gap:.3e}")
        assert len(np.unique(want)) > 8
        with torch.no_grad():
            dec = q.from_codes(got)
        np.testing.assert_allclose(
            dec.numpy(), np.asarray(jq.apply(qv, jnp.asarray(want),
                                             method="from_codes")), **TOL)

    def test_fsq(self):
        """The vendored bound (tan, 1 - eps) within 1e-6; indices exact on
        values spread over every level, and their codes JAX's quantized
        values exactly."""
        z = np.random.default_rng(13).uniform(-4, 4, (4000, 3)).astype(
            np.float32)
        z[::7] = np.linspace(-4, 4, 572, dtype=np.float32)[:, None]
        jf = j_flexi.FlexiFSQ(3, (8, 5, 4))
        tf = t_flexi.FlexiFSQ(3, (8, 5, 4))
        np.testing.assert_allclose(
            tf.bound(torch.as_tensor(z)).numpy(),
            np.asarray(jf.apply({}, jnp.asarray(z), method="bound")),
            atol=1e-6, rtol=1e-6)
        jq, ji = jf.apply({}, jnp.asarray(z))
        ti = tf.indices(torch.as_tensor(z))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tf.from_indices(ti).numpy(),
                                      np.asarray(jq))
        assert [len(np.unique(np.asarray(jq)[:, i])) for i in range(3)] \
            == [8, 5, 4]

    def test_semantic_adapters(self, dual):
        cfg, variables, _, port = dual
        x = np.random.default_rng(6).standard_normal(
            (1, T, cfg.ssl_dim)).astype(np.float32)
        p = variables["params"]
        want = j_flexi.SemanticEncoderCNX(
            cfg.convnext_dim, cfg.convnext_layers).apply(
                {"params": p["convnext_encoder"]}, x)
        with torch.no_grad():
            got = port.convnext_encoder(torch.as_tensor(x))
            back = port.convnext_decoder(got)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(back.numpy(), np.asarray(
            j_flexi.SemanticDecoderCNX(
                cfg.convnext_dim, cfg.latent_dim, cfg.convnext_layers).apply(
                {"params": p["convnext_decoder"]}, want)), **TOL)


class TestCodec:
    @pytest.mark.parametrize("seed", [7, 8])
    def test_dualcodec_round_trip(self, dual, seed):
        """DualCodec mode: (B, T, nq) and (B, T, 1) codes exact, the
        waveform of decode within 1e-4 of its peak."""
        cfg, variables, jm, port = dual
        wav, sem = _inputs(seed)
        ja, js = jm.apply(variables, wav, sem, method="encode")
        with torch.no_grad():
            ta, ts = port.encode(torch.as_tensor(wav), torch.as_tensor(sem))
        assert ta.shape == (1, T, cfg.n_codebooks) and ts.shape == (1, T, 1)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert len(np.unique(np.asarray(ja))) > 4
        with torch.no_grad():
            rec = port.decode(ta, ts).numpy()
        _peak_close(rec, jm.apply(variables, ja, js, method="decode"))

    @pytest.mark.parametrize("seed", [9, 10])
    def test_aligned_round_trip(self, aligned, seed):
        """Aligned mode: group codes with the lengths injected and -1 at
        padding groups exactly JAX's (the similarity margin in the
        message), decode within 1e-4 of the peak."""
        cfg, variables, jm, port = aligned
        wav, sem = _inputs(seed)
        s = np.asarray(sem, np.float64).reshape(1, T, 2, -1).mean(2)
        n = s / np.linalg.norm(s, axis=-1, keepdims=True)
        sims = (n[:, 1:] * n[:, :-1]).sum(-1)
        s_sorted = np.sort(sims.ravel())
        thr = float((s_sorted[T // 2 - 1] + s_sorted[T // 2]) / 2)
        ja, js = jm.apply(variables, wav, sem, method="encode", threshold=thr)
        with torch.no_grad():
            ta, ts = port.encode(torch.as_tensor(wav), torch.as_tensor(sem),
                                 threshold=thr)
        msg = f"min |sim - thr| {np.abs(sims - thr).min():.3e}"
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=msg)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js),
                                      err_msg=msg)
        valid = ta.numpy()[0, :, 0] >= 0
        assert 1 < valid.sum() < T
        assert (ta.numpy()[0, valid, 0] // cfg.codebook_size + 1).sum() == T
        with torch.no_grad():
            rec = port.decode(ta, ts).numpy()
        _peak_close(rec, jm.apply(variables, ja, js, method="decode"))


class TestSemanticStreams:
    @pytest.mark.parametrize("t,n", [(13, 16), (16, 16), (30, 16), (5, 33)])
    def test_match_frame_rate(self, t, n):
        x = np.random.default_rng(t).standard_normal(
            (2, t, 3)).astype(np.float32)
        got = t_flexi.match_frame_rate(torch.as_tensor(x), n).numpy()
        want = np.asarray(j_flexi.match_frame_rate(jnp.asarray(x), n))
        assert got.shape == (2, n, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got[:, [0, -1]], x[:, [0, -1]])

    def test_fbank_semantic(self):
        """The log-mel fallback tiled to ``out_dim``: within 1e-4."""
        wav = _inputs(11)[0]
        want = np.asarray(j_flexi.fbank_semantic(jnp.asarray(wav),
                                                 out_dim=200))
        got = t_flexi.fbank_semantic(torch.as_tensor(wav),
                                     out_dim=200).numpy()
        assert got.shape == want.shape == (1, HOP * T // 160 + 1, 200)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got[..., 80:160], got[..., :80])


def test_cli_codec_flexicodec_three_streams(dual, tmp_path, monkeypatch,
                                           capsys):
    """``main(["codec", "--model", "flexicodec", "--ckpt", SD, "--device",
    "cpu"])`` against the JAX package's ``cmd_codec`` on the tiny stack,
    with each semantic stream: the log-fbank fallback, ``--cmvn`` (the
    teacher's frontend) and ``--cmvn --sensevoice-ckpt`` (the SAN-M
    teacher, a funasr-layout state dict): the same JSON line and the same
    16-bit waveform within one PCM step plus 1e-4 of its peak. Also: the
    port's random weights without ``--ckpt``, ``--sensevoice-ckpt``
    without ``--cmvn`` and ``--dtype bfloat16`` refused."""
    from unified_audio_tpu import cli as j_cli

    cfg, variables = dual[:2]
    sv_cfg = tiny_sanm_config(input_size=560)
    sv_vars = sanm_variables(sv_cfg, seed=12)
    ckpt, sv_ckpt = tmp_path / "flexi.pt", tmp_path / "sensevoice.pt"
    torch.save(to_torch(export_flexicodec_state_dict(variables, cfg)), ckpt)
    torch.save(to_torch(funasr_state_dict(sv_vars, sv_cfg)), sv_ckpt)
    cmvn = write_cmvn(tmp_path / "am.mvn", 560)
    n = HOP * T - 200
    write_wav(tmp_path / "in.wav", _inputs(12)[0][0, :n], 16000)
    monkeypatch.setattr(j_flexi, "FlexiCodecConfig",
                        lambda **kw: dataclasses.replace(cfg, **kw))
    monkeypatch.setattr(j_sanm, "sensevoice_small_config", lambda: sv_cfg)
    monkeypatch.setattr(cli, "_build_flexicodec", functools.partial(
        cli._build_flexicodec, cfg=port_cfg(cfg)))
    monkeypatch.setattr(cli, "_build_sensevoice", functools.partial(
        cli._build_sensevoice, cfg=t_sanm.SANMConfig(
            **dataclasses.asdict(sv_cfg))))
    args = ["codec", "--model", "flexicodec", "--input",
            str(tmp_path / "in.wav"), "--ckpt", str(ckpt)]
    out = str(tmp_path / "out.wav")
    for extra in ([], ["--cmvn", str(cmvn)],
                  ["--cmvn", str(cmvn), "--sensevoice-ckpt", str(sv_ckpt)]):
        j_cli.main([*args, "--output", out, *extra])
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        jw, _ = read_wav(out)
        got = cli.main([*args, "--output", out, *extra, "--device", "cpu"])
        assert got == want, extra
        assert got["acoustic_shape"] == [1, (n // HOP), cfg.n_codebooks]
        tw, fs = read_wav(out)
        assert fs == 16000 and tw.shape == jw.shape
        _peak_close(tw, jw, PCM_STEP)
    got = cli.main(["codec", "--model", "flexicodec", "--input",
                    str(tmp_path / "in.wav"), "--output", out, "--device",
                    "cpu"])
    assert got["acoustic_shape"][2] == cfg.n_codebooks
    assert np.isfinite(read_wav(out)[0]).all()
    with pytest.raises(SystemExit, match="needs the teacher's CMVN"):
        cli.main([*args, "--output", out, "--sensevoice-ckpt", str(sv_ckpt),
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="hcodec10 and hcodec20"):
        cli.main([*args, "--output", out, "--dtype", "bfloat16", "--device",
                  "cpu"])
