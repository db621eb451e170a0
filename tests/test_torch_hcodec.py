"""The HCodec-1.0 and 2.0 round trips of the port
(``unified_audio_tpu_torch``) against the JAX package on the CPU, at the
tiny ``small10()`` and ``small20()`` configs of tests/test_hcodec.py with a
tiny HuBERT frontend.

The same numpy-seeded weights (carried over by ``hcodec10_state_dict`` /
``hcodec20_state_dict`` and ``hubert_state_dict``) and inputs go through
both. Modules within atol/rtol 1e-4; tokenize codes exact; detokenize
within 1e-4 of the waveform's peak. ``UniTokPipeline`` runs a tiny UniTok
LM over the 1.0 tokenizer.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables, to_torch
from unified_audio_tpu.models.hcodec import codec as j_codec
from unified_audio_tpu.models.hcodec.tokenizer import HCodecTokenizer
from unified_audio_tpu.models.ssl import wav2vec2 as j_ssl
from unified_audio_tpu.nn import blocks as j_blocks
from unified_audio_tpu.nn.transformer import Transformer as JTransformer
from unified_audio_tpu.ops import dsp as j_dsp
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav
from unified_audio_tpu_torch.models.hcodec import codec as t_codec
from unified_audio_tpu_torch.models.hcodec.tokenizer import (
    HCodecTokenizer as THCodecTokenizer)
from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl
from unified_audio_tpu_torch.nn import blocks as t_blocks
from unified_audio_tpu_torch.ops import dsp as t_dsp
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.utils import convert as t_convert

L = 640 * 8  # 8 tokens at 25 Hz


def small10():
    return j_codec.hcodec10_config(
        latent_dim=64, seanet_filters=4, codebook_size=32, num_quantizers=2,
        decoder_dim=64, decoder_intermediate_dim=128,
        decoder_convnext_layers=2, semantic_encode_channels=64, feat_dim=32)


def small20():
    return j_codec.hcodec20_config(
        latent_dim=64, codebook_size=32, num_quantizers=2,
        decoder_dim=64, decoder_intermediate_dim=128,
        decoder_convnext_layers=2, encoder_dim=64,
        encoder_intermediate_dim=128, encoder_convnext_layers=2,
        semantic_encode_channels=64, feat_dim=32)


def tiny_hubert(hidden=32):
    return j_ssl.SSLConfig(
        hidden_size=hidden, num_layers=2, num_heads=4, intermediate_size=32,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4)


def seeded_models(cfg, length, seed=4):
    """Seeded JAX variables of ``cfg`` (traced on ``length`` samples), the
    JAX tokenizer, and the port's tokenizer with the same weights. The
    codebooks are unit normal scaled to each stream's latent spread, so the
    codes vary from frame to frame."""
    ssl_cfg = tiny_hubert()
    wav = np.zeros((1, length, 1), np.float32)
    frames = length // (320 if cfg.version == "1.0" else 960)
    feat = np.zeros((1, frames, cfg.feat_dim), np.float32)
    variables = jax.device_get(random_variables(
        j_codec.HCodec(cfg), wav, feat, seed=seed))
    ssl_vars = jax.device_get(random_variables(
        j_ssl.Wav2Vec2Model(ssl_cfg), np.zeros((1, 3200), np.float32),
        seed=seed + 1))
    jtok = HCodecTokenizer(cfg, variables, ssl_cfg, ssl_vars)
    x = jnp.asarray(_wav(seed - 4, length, cfg.sample_rate))
    emb, sem = jtok.codec.apply(
        variables, x[..., None], jtok.extract_features(x),
        method=j_codec.HCodec._encode_latents)
    rng = np.random.default_rng(seed + 2)
    for name, lat in (("quantizer", emb), ("semantic_quantizer", sem)):
        for layer in variables["codebook"][name].values():
            layer["embed"] = (float(np.std(lat)) * rng.standard_normal(
                layer["embed"].shape)).astype(np.float32)
    jtok = HCodecTokenizer(cfg, variables, ssl_cfg, ssl_vars)
    return cfg, ssl_cfg, variables, ssl_vars, jtok, port_tokenizer(
        cfg, variables, ssl_cfg, ssl_vars)


@pytest.fixture(scope="module")
def models():
    return seeded_models(small10(), L)


def port_tokenizer(cfg, variables, ssl_cfg, ssl_vars):
    export = (t_convert.hcodec10_state_dict if cfg.version == "1.0"
              else t_convert.hcodec20_state_dict)
    codec = t_codec.HCodec(t_codec.HCodecConfig(**dataclasses.asdict(cfg)))
    codec.load_state_dict(to_torch(t_convert.hcodec_inference_keys(
        export(variables, cfg))))
    ssl = t_ssl.Wav2Vec2Model(t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg)))
    ssl.load_state_dict(to_torch(t_convert.hubert_state_dict(ssl_vars,
                                                             ssl_cfg)))
    return THCodecTokenizer(codec, ssl)


def _wav(seed, n=L, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.4 * np.sin(2 * np.pi * 180 * t) + 0.1 * rng.standard_normal(n)
    return x[None].astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


class TestModules:
    def test_seanet_encoder(self, models):
        cfg, _, variables, _, _, tok = models
        x = _wav(1)[..., None]
        want = j_blocks.SEANetEncoder(
            dimension=cfg.latent_dim, n_filters=cfg.seanet_filters,
            ratios=cfg.seanet_ratios).apply(
                {"params": variables["params"]["encoder"]}, x)
        with torch.no_grad():
            got = tok.codec.encoder(torch.as_tensor(x))
        assert got.shape == (1, L // 640, cfg.latent_dim)
        _close(got, want)

    def test_semantic_encoder(self, models):
        cfg, _, variables, _, _, tok = models
        feat = np.random.default_rng(2).standard_normal(
            (1, 16, cfg.feat_dim)).astype(np.float32)
        want = j_codec.SemanticEncoder(
            cfg.feat_dim, cfg.semantic_encode_channels, cfg.latent_dim,
            cfg.semantic_ratios, cfg.semantic_strides).apply(
                {"params": variables["params"]["semantic_encoder"]}, feat)
        with torch.no_grad():
            got = tok.codec.semantic_encoder(torch.as_tensor(feat))
        assert got.shape == (1, 8, cfg.latent_dim)
        _close(got, want)

    @pytest.mark.parametrize("causal", [False, True])
    def test_hybrid_transformer(self, models, causal):
        """The encoder's 2-layer LSTM-attention transformer, with full
        attention (as HCodec-1.0 runs it) and under the causal mask."""
        cfg, _, variables, _, _, tok = models
        x = np.random.default_rng(3).standard_normal(
            (2, 11, cfg.latent_dim)).astype(np.float32)
        want = JTransformer(hidden_size=cfg.latent_dim,
                            intermediate_size=4 * cfg.latent_dim, num_heads=8,
                            num_layers=2, causal=causal).apply(
            {"params": variables["params"]["encoder"]["transformer"]}, x)
        port = tok.codec.encoder.model[14]
        port.causal = causal
        try:
            with torch.no_grad():
                got = port(torch.as_tensor(x))
        finally:
            port.causal = False
        _close(got, want)

    @pytest.mark.parametrize("causal", [False, True])
    def test_constant_pad_conv(self, causal):
        """CausalConv1d: zeros (K - 1, 0) causal, (K // 2, K // 2) not."""
        from unified_audio_tpu.nn.conv import CausalConv1d as JConv
        from unified_audio_tpu_torch.nn.conv import CausalConv1d as TConv

        rng = np.random.default_rng(10)
        x = rng.standard_normal((2, 9, 6)).astype(np.float32)
        kernel = rng.standard_normal((5, 6, 4)).astype(np.float32)
        bias = rng.standard_normal(4).astype(np.float32)
        want = JConv(4, 5, causal=causal).apply(
            {"params": {"kernel": kernel, "bias": bias}}, x)
        port = TConv(6, 4, 5, causal=causal)
        port.load_state_dict({
            "conv.weight": torch.as_tensor(kernel.transpose(2, 1, 0).copy()),
            "conv.bias": torch.as_tensor(bias)})
        with torch.no_grad():
            _close(port(torch.as_tensor(x)), want)

    @pytest.mark.parametrize("length,pads", [(9, (3, 4)), (2, (3, 4)),
                                             (3, (3, 0))])
    def test_reflect_pad_of_short_input(self, length, pads):
        """pad1d's reflect mode equals the JAX package's, also for an input
        no longer than the pad (zero-extended first, where F.pad raises)."""
        from unified_audio_tpu.nn.conv import pad1d as j_pad1d
        from unified_audio_tpu_torch.nn.conv import pad1d as t_pad1d

        x = np.random.default_rng(11).standard_normal(
            (2, length, 3)).astype(np.float32)
        _close(t_pad1d(torch.as_tensor(x), pads),
               j_pad1d(jnp.asarray(x), pads, mode="reflect"), atol=0, rtol=0)

    def test_prior_net(self, models):
        cfg, _, variables, _, _, tok = models
        x = np.random.default_rng(4).standard_normal(
            (1, 12, cfg.decoder_dim)).astype(np.float32)
        want = j_codec.PriorNet(cfg.decoder_dim).apply(
            {"params": variables["params"]["decoder"]["prior_net"]}, x)
        with torch.no_grad():
            got = tok.codec.decoder.prior_net(torch.as_tensor(x))
        _close(got, want)

    def test_codec_decoder(self, models):
        cfg, _, variables, _, _, tok = models
        x = np.random.default_rng(5).standard_normal(
            (1, 8, 2 * cfg.latent_dim)).astype(np.float32)
        want = j_codec.CodecDecoder10(
            dim=cfg.decoder_dim, intermediate_dim=cfg.decoder_intermediate_dim,
            convnext_layers=cfg.decoder_convnext_layers, n_fft=cfg.n_fft,
            hop_length=cfg.istft_hop).apply(
                {"params": variables["params"]["decoder"]}, x)
        with torch.no_grad():
            got = tok.codec.decoder(torch.as_tensor(x))
        assert got.shape == (1, 8 * 640)
        _close(got, want)

    def test_istft_same(self):
        rng = np.random.default_rng(6)
        spec = (rng.standard_normal((2, 641, 9))
                + 1j * rng.standard_normal((2, 641, 9))).astype(np.complex64)
        want = j_dsp.istft_same(jnp.asarray(spec), 1280, 320)
        got = t_dsp.istft_same(torch.as_tensor(spec), 1280, 320)
        assert got.shape == (2, 9 * 320)
        _close(got, want)

    def test_hubert_features(self, models):
        _, ssl_cfg, _, ssl_vars, _, tok = models
        wav = _wav(7, 3520)
        want = j_ssl.hubert_features(j_ssl.Wav2Vec2Model(ssl_cfg).apply(
            ssl_vars, wav))
        with torch.no_grad():
            got = t_ssl.hubert_features(tok.ssl(torch.as_tensor(wav)))
        _close(got, want)


class TestRoundTrip:
    def test_tokenize_exact_detokenize_close(self, models):
        """Codes equal the JAX package's exactly, and the waveform of those
        codes agrees within 1e-4 of its peak (the ISTFT's exp can amplify
        rounding, so the bound is relative to the peak, not per sample)."""
        cfg, _, _, _, jtok, tok = models
        wav = _wav(8, L - 200)  # padded to the hop inside tokenize
        jac, jsem = jtok.tokenize(jnp.asarray(wav))
        ac, sem = tok.tokenize(torch.as_tensor(wav))
        assert ac.shape == sem.shape == (1, cfg.num_quantizers, L // 640)
        np.testing.assert_array_equal(ac.numpy(), np.asarray(jac))
        np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem))
        assert len(np.unique(np.asarray(jac))) > 3, "degenerate codes"
        want = np.asarray(jtok.detokenize(jac, jsem))
        got = tok.detokenize(ac, sem).numpy()
        assert got.shape == want.shape == (1, L)
        peak = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * peak

    def test_cli_codec_end_to_end(self, models, tmp_path, monkeypatch):
        """``main(["codec", ..., "--device", "cpu"])`` at the tiny config:
        random weights from the seed, then again from a checkpoint in the
        layout of ``hcodec10_state_dict`` (semantic decoder and EMA keys
        included, which the loader drops)."""
        cfg, ssl_cfg, variables, _, jtok, _ = models
        monkeypatch.setattr(cli, "_build_hcodec", functools.partial(
            cli._build_hcodec, cfg=t_codec.HCodecConfig(
                **dataclasses.asdict(cfg)),
            ssl_cfg=t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg))))
        n = L - 300
        write_wav(tmp_path / "in.wav", _wav(9, n)[0], 16000)
        ckpt = tmp_path / "hcodec10.pt"
        torch.save(to_torch(t_convert.hcodec10_state_dict(variables, cfg)),
                   ckpt)
        for extra in ([], ["--ckpt", str(ckpt)]):
            out = tmp_path / f"out{len(extra)}.wav"
            summary = cli.main(["codec", "--model", "hcodec10", "--input",
                                str(tmp_path / "in.wav"), "--output",
                                str(out), "--device", "cpu", *extra])
            assert summary["acoustic_shape"] == [1, cfg.num_quantizers,
                                                 L // 640]
            assert summary["tokens_per_sec"] == round(
                (L // 640) / (n / 16000), 2)
            rec, fs = read_wav(out)
            assert fs == 16000 and rec.shape == (1, L)
            assert np.isfinite(rec).all()


@pytest.mark.parametrize("build", [
    lambda: (t_blocks.SamplingBlock(8, 8, upsample_scale=2), (1, 10, 8)),
    lambda: (t_quant.FactorizedVectorQuantize(8, 16, 8, tokenize=True),
             (1, 5, 8)),
    lambda: (t_codec.Transformer(64, 128, 1, 1, use_moe=True), (1, 5, 64))])
def test_parts_not_ported_raise(build):
    """Parts no shipped model builds, which once refused to build (the
    sampling block above ratio 1, the identity-projection FVQ, the MoE
    transformer), build and run now: none raises, each gives its shape
    (each is held to JAX in ``tests/test_torch_blocks_rest.py`` and
    ``tests/test_torch_moe.py``). The causal HCodec-1.0 and 2.0 are in
    ``tests/test_torch_causal.py``."""
    m, out_shape = build()
    x = torch.randn(1, 5, out_shape[-1])
    with torch.no_grad():
        if isinstance(m, t_quant.FactorizedVectorQuantize):
            y = m.detokenize(m.tokenize(x))
        else:
            y = m(x)
    assert tuple(y.shape) == out_shape and bool(torch.isfinite(y).all())


L20 = 3840 * 4  # 4 tokens at 12.5 Hz, 48 kHz


@pytest.fixture(scope="module")
def models20():
    return seeded_models(small20(), L20)


class TestHCodec20:
    def test_codec_encoder20(self, models20):
        """The STFT encoder (log |S| and angle / pi of an uncentered STFT,
        the (480, 480)-padded wav) at the JAX package's values."""
        cfg, _, variables, _, _, tok = models20
        x = _wav(20, L20, 48000)
        want = j_codec.CodecEncoder20(
            dim=cfg.encoder_dim, intermediate_dim=cfg.encoder_intermediate_dim,
            dimension=cfg.latent_dim, n_fft=cfg.n_fft,
            hop_length=cfg.istft_hop,
            convnext_layers=cfg.encoder_convnext_layers).apply(
                {"params": variables["params"]["encoder"]}, x)
        with torch.no_grad():
            got = tok.codec.encoder(torch.as_tensor(x))
        assert got.shape == (1, 4, cfg.latent_dim)
        _close(got, want)

    def test_codec_decoder20(self, models20):
        """Repeat-interleave x4 on time, the prior net, the ConvNeXt stack
        and the ISTFT head (n_fft 1920, hop 960)."""
        cfg, _, variables, _, _, tok = models20
        x = np.random.default_rng(21).standard_normal(
            (1, 4, 2 * cfg.latent_dim)).astype(np.float32)
        want = j_codec.CodecDecoder20(
            dim=cfg.decoder_dim, intermediate_dim=cfg.decoder_intermediate_dim,
            convnext_layers=cfg.decoder_convnext_layers, n_fft=cfg.n_fft,
            hop_length=cfg.istft_hop).apply(
                {"params": variables["params"]["decoder"]}, x)
        with torch.no_grad():
            got = tok.codec.decoder(torch.as_tensor(x))
        assert got.shape == (1, L20)
        _close(got, want)

    def test_strided_constant_pad_conv(self):
        """The 2.0 encoder's out conv: kernel 9, stride 4, zeros (4, 4)."""
        from unified_audio_tpu.nn.conv import CausalConv1d as JConv
        from unified_audio_tpu_torch.nn.conv import CausalConv1d as TConv

        rng = np.random.default_rng(22)
        x = rng.standard_normal((2, 16, 6)).astype(np.float32)
        kernel = rng.standard_normal((9, 6, 5)).astype(np.float32)
        bias = rng.standard_normal(5).astype(np.float32)
        want = JConv(5, 9, stride=4).apply(
            {"params": {"kernel": kernel, "bias": bias}}, x)
        port = TConv(6, 5, 9, stride=4)
        port.load_state_dict({
            "conv.weight": torch.as_tensor(kernel.transpose(2, 1, 0).copy()),
            "conv.bias": torch.as_tensor(bias)})
        with torch.no_grad():
            got = port(torch.as_tensor(x))
        assert got.shape == (2, 4, 5)
        _close(got, want)

    def test_roundtrip_48k_codes_exact(self, models20):
        """48 kHz in, HuBERT on the resampled 16 kHz audio (L / 960 frames),
        hop 3840: codes equal the JAX package's, the waveform within 1e-4
        of its peak."""
        cfg, _, _, _, jtok, tok = models20
        wav = _wav(23, L20 - 1000, 48000)  # padded to the hop inside
        jac, jsem = jtok.tokenize(jnp.asarray(wav))
        ac, sem = tok.tokenize(torch.as_tensor(wav))
        assert ac.shape == sem.shape == (1, cfg.num_quantizers, 4)
        np.testing.assert_array_equal(ac.numpy(), np.asarray(jac))
        np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem))
        assert len(np.unique(np.asarray(jac))) > 3, "degenerate codes"
        feats = tok.extract_features(tok.pad_wav(torch.as_tensor(wav)))
        assert feats.shape[1] == L20 // 960
        want = np.asarray(jtok.detokenize(jac, jsem))
        got = tok.detokenize(ac, sem).numpy()
        assert got.shape == want.shape == (1, L20)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    def test_cli_codec_hcodec20_end_to_end(self, models20, tmp_path,
                                           monkeypatch):
        """``main(["codec", "--model", "hcodec20", ..., "--device", "cpu"])``
        at the tiny config on a 44.1 kHz wav: resampled to 48 kHz (said on
        stderr), 4 codes for the 0.25 s (the input is padded to the hop), a
        finite 48 kHz wav of the padded length out; then again from a
        checkpoint in the layout of ``hcodec20_state_dict`` (loaded
        strictly), which changes the output."""
        cfg, ssl_cfg, variables = models20[:3]
        monkeypatch.setattr(cli, "_build_hcodec", functools.partial(
            cli._build_hcodec, cfg=t_codec.HCodecConfig(
                **dataclasses.asdict(cfg)),
            ssl_cfg=t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg))))
        n_in = 11025  # 0.25 s at 44.1 kHz -> 12,000 samples at 48 kHz
        write_wav(tmp_path / "in.wav", _wav(24, n_in, 44100)[0], 44100)
        ckpt = tmp_path / "hcodec20.pt"
        torch.save(to_torch(t_convert.hcodec20_state_dict(variables, cfg)),
                   ckpt)
        codes = []
        monkeypatch.setattr(cli, "write_wav", lambda *a: codes.append(a))
        for extra in ([], ["--ckpt", str(ckpt)]):
            summary = cli.main(["codec", "--model", "hcodec20", "--input",
                                str(tmp_path / "in.wav"), "--output",
                                str(tmp_path / "out.wav"), "--device", "cpu",
                                *extra])
            assert summary["acoustic_shape"] == [1, cfg.num_quantizers, 4]
            assert summary["tokens_per_sec"] == round(4 / 0.25, 2)
            path, rec, fs = codes[-1]
            assert fs == 48000 and rec.shape == (L20,)
            assert np.isfinite(rec).all()
        x = cli._prepare_wav(read_wav(tmp_path / "in.wav")[0], 44100, 48000)
        assert x.shape == (1, 12000)
        assert not np.allclose(codes[0][1], codes[1][1])


class TestUniTokPipeline:
    """``UniTokPipeline`` (the UniTok LM between HCodec-1.0's features and
    codes) against the JAX package's on the tiny codec above and a tiny
    UniTok LM over its 2 x 2 codebooks of 32: codes exact, generated
    waveforms within 1e-4 of the peak."""

    @pytest.fixture(scope="class")
    def pipes(self, models):
        from test_torch_unitok import port_unitok
        from unified_audio_tpu.models.unitok.model import (UniTokConfig,
                                                           UniTokLM)
        from unified_audio_tpu.models.unitok.pipeline import (
            UniTokPipeline as JPipeline)
        from unified_audio_tpu_torch.models.unitok.pipeline import (
            UniTokPipeline)

        cfg, ssl_cfg, _, _, jtok, tok = models
        ucfg = UniTokConfig(codebook_size=cfg.codebook_size,
                            num_quantizers=cfg.num_quantizers,
                            hidden_size=32, num_layers=2, num_heads=4,
                            text_dim=8, audio_dim=ssl_cfg.hidden_size,
                            max_positions=256)
        jlm = UniTokLM(ucfg)
        lm_vars = jax.device_get(random_variables(
            jlm, 0, np.zeros((1, 2, ucfg.text_dim), np.float32), None,
            np.zeros((1, 4, ucfg.audio_dim), np.float32),
            np.zeros((1, 4, ucfg.num_codebooks), np.int32), seed=9))
        return (JPipeline(jtok, jlm, lm_vars),
                UniTokPipeline(tok, port_unitok(ucfg, lm_vars)))

    def test_audio_to_codes_exact(self, pipes):
        jpipe, pipe = pipes
        wav = _wav(10)
        want = np.asarray(jpipe.audio_to_codes(jnp.asarray(wav)))
        got = pipe.audio_to_codes(torch.as_tensor(wav))
        assert got.shape == (1, L // 640, 4)
        np.testing.assert_array_equal(got.numpy(), want)
        back = pipe.codes_to_audio(got)
        _close(back, jpipe.codes_to_audio(jnp.asarray(want)), atol=1e-4 * float(
            np.abs(np.asarray(back)).max()), rtol=0)

    def test_greedy_generate_matches_jax(self, pipes):
        """A TSE request (reference clip and input clip), greedy: the LM's
        codes and so the waveform equal JAX's."""
        jpipe, pipe = pipes
        wav, ref = _wav(11, L - 100), _wav(12, 640 * 3)
        want = np.asarray(jpipe.generate("tse", jnp.asarray(wav),
                                         jax.random.PRNGKey(0),
                                         ref_wav=jnp.asarray(ref),
                                         do_sample=False))
        got = pipe.generate("tse", torch.as_tensor(wav),
                            ref_wav=torch.as_tensor(ref), do_sample=False)
        assert got.shape == want.shape == (1, (L - 100) // 640 * 640)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()

    def test_from_random_runs_on_the_card_unless_asked(self, models,
                                                       monkeypatch):
        """``from_random`` defaults to the card and raises without one;
        with ``device="cpu"`` it builds and a sampled generate gives a
        finite waveform of the requested frames."""
        from unified_audio_tpu_torch.models.hcodec.codec import HCodecConfig
        from unified_audio_tpu_torch.models.unitok import model as t_model
        from unified_audio_tpu_torch.models.unitok.pipeline import (
            UniTokPipeline)

        cfg, ssl_cfg = models[:2]
        kw = dict(codec_config=HCodecConfig(**dataclasses.asdict(cfg)),
                  ssl_config=t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg)),
                  lm_config=t_model.UniTokConfig(
                      codebook_size=cfg.codebook_size,
                      num_quantizers=cfg.num_quantizers, hidden_size=32,
                      num_layers=2, num_heads=4, text_dim=8,
                      audio_dim=ssl_cfg.hidden_size))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            UniTokPipeline.from_random(**kw)
        pipe = UniTokPipeline.from_random(device="cpu", **kw)
        out = pipe.generate("sr", torch.as_tensor(_wav(13)), num_frames=3,
                            generator=torch.Generator().manual_seed(0))
        assert out.shape == (1, 3 * 640) and torch.isfinite(out).all()
