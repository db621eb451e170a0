"""HCodec-1.5 adaptive of the port (``unified_audio_tpu_torch``) against the
JAX package on the CPU: the grouping functions, the Mimi transformer, the
query-token aggregator, the codec's encode/decode, the XLSR tokenizer and
``cli codec --model hcodec15``, at a tiny configuration (``small10()``
widths, 2-layer aggregators, a 1-layer bottleneck, the tiny 17-layer
XLSR).

Weights are the JAX package's seeded variables carried over by its own
``export_hcodec15_state_dict`` (the reference layout the port loads).
Tolerances: group ids, lengths and codes exact; RoPE within 1e-6; Mimi
layers, aggregators and waveforms within atol/rtol 1e-4 (waveforms within
1e-4 of their peak). Where a test segments, its message reports the
smallest |similarity - threshold| of its inputs, so that a flipped
boundary shows as a near tie rather than a fault.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (TOL, random_variables, tiny_xlsr_config,
                               to_torch, xlsr_variables)
from test_torch_hcodec import small10
from unified_audio_tpu.models.hcodec import adaptive as j_adaptive
from unified_audio_tpu.models.hcodec.adaptive_tokenizer import (
    AdaptiveHCodecTokenizer as JTokenizer)
from unified_audio_tpu.nn import mimi as j_mimi
from unified_audio_tpu.utils.convert_hcodec import (
    _inv_mimi_transformer, export_hcodec15_state_dict)
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav
from unified_audio_tpu_torch.models.hcodec import adaptive as t_adaptive
from unified_audio_tpu_torch.models.hcodec import codec as t_codec
from unified_audio_tpu_torch.models.hcodec.adaptive_tokenizer import (
    AdaptiveHCodecTokenizer as TTokenizer)
from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl
from unified_audio_tpu_torch.nn import mimi as t_mimi
from unified_audio_tpu_torch.utils import convert as t_convert

T = 12  # frames (25 Hz) of the codec tests
L = 640 * T


def tiny_cfg(**kw):
    """small10() over the 16-wide tiny XLSR, 2-layer aggregators (d 64, 8
    heads of 8), a 1-layer bottleneck (d 128)."""
    base = dict(base=dataclasses.replace(small10(), feat_dim=16),
        similarity_threshold=0.5, max_group_len=4, aggregator_layers=2,
        aggregator_ff=128, bottleneck_layers=1, bottleneck_ff=128)
    base.update(kw)
    return j_adaptive.AdaptiveConfig(**base)


def port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "base"}
    return t_adaptive.AdaptiveConfig(
        base=t_codec.HCodecConfig(**dataclasses.asdict(cfg.base)), **fields)


def port_codec(cfg, variables):
    m = t_adaptive.AdaptiveHCodec(port_cfg(cfg))
    m.load_state_dict(to_torch(t_convert.hcodec15_inference_keys(
        export_hcodec15_state_dict(variables, cfg))))
    return m.eval()


def _inputs(seed, t=T, feat_dim=16):
    rng = np.random.default_rng(seed)
    tt = np.arange(640 * t) / 16000
    wav = (0.4 * np.sin(2 * np.pi * 180 * tt)
           + 0.1 * rng.standard_normal(640 * t)).astype(np.float32)
    feat = rng.standard_normal((1, 2 * t, feat_dim)).astype(np.float32)
    return wav[None, :, None], feat


def margin(sims, thr):
    return float(np.min(np.abs(np.asarray(sims) - thr)))


def _sims(emb):
    e = np.asarray(emb, np.float64)
    n = e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-8)
    return (n[:, 1:] * n[:, :-1]).sum(-1)


def mid_threshold(sims):
    """A threshold halfway between the two similarities around the median,
    so that about half the frames start a group and none is near it."""
    s = np.sort(np.asarray(sims).ravel())
    i = len(s) // 2
    return float((s[i - 1] + s[i]) / 2)


@pytest.fixture(scope="module")
def models():
    """(cfg, JAX variables with codebooks at the groups' spread, the JAX
    module, the port's codec)."""
    return seeded_models(tiny_cfg())


def seeded_models(cfg):
    """:func:`models` for ``cfg`` (also the causal one of
    ``tests/test_torch_causal.py``)."""
    wav, feat = _inputs(0)
    jm = j_adaptive.AdaptiveHCodec(cfg)
    variables = jax.device_get(random_variables(jm, wav, feat, seed=3))
    a_groups, s_groups, _, counts = jm.apply(variables, wav, feat,
                                             method="_align")
    valid = np.asarray(counts)[0] > 0
    rng = np.random.default_rng(4)
    for name, g in (("quantizer", a_groups), ("semantic_quantizer",
                                              s_groups)):
        scale = float(np.std(np.asarray(g)[0, valid]))
        for layer in variables["codebook"][name].values():
            layer["embed"] = (scale * rng.standard_normal(
                layer["embed"].shape)).astype(np.float32)
    return cfg, variables, jm, port_codec(cfg, variables)


class TestGrouping:
    @pytest.mark.parametrize("max_len", [2, 4, 8])
    def test_similarity_group_ids_exact(self, max_len):
        """Group ids equal JAX's over random frames at three thresholds."""
        rng = np.random.default_rng(max_len)
        emb = rng.standard_normal((3, 40, 6)).astype(np.float32)
        emb[:, 1:] += 1.5 * emb[:, :-1]  # runs of similar frames
        sims = _sims(emb)
        for thr in (mid_threshold(sims), 0.2, 0.9):
            want = j_adaptive.similarity_group_ids(jnp.asarray(emb), thr,
                                                   max_len)
            got = t_adaptive.similarity_group_ids(torch.as_tensor(emb), thr,
                                                  max_len)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want),
                err_msg=f"min |sim - thr| {margin(sims, thr):.3e}")

    @pytest.mark.parametrize("emb,thr,max_len,want", [
        (np.ones((1, 6, 4)), 0.9, 8, [[0] * 6]),
        (np.stack([np.ones(4), -np.ones(4)] * 2)[None], 0.5, 8,
         [[0, 1, 2, 3]]),
        (np.ones((1, 10, 4)), 0.5, 4, [[0, 0, 0, 0, 1, 1, 1, 1, 2, 2]]),
        (np.ones((1, 1, 4)), 0.5, 4, [[0]])])
    def test_segmentation_cases(self, emb, thr, max_len, want):
        """Identical frames, alternating frames, the length rule, one
        frame: the port and JAX give the same ids."""
        emb = emb.astype(np.float32)
        got = t_adaptive.similarity_group_ids(torch.as_tensor(emb), thr,
                                              max_len)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(
            j_adaptive.similarity_group_ids(jnp.asarray(emb), thr,
                                            max_len)), want)

    def test_lengths_inverse_and_degroup(self):
        rng = np.random.default_rng(5)
        emb = rng.standard_normal((2, 12, 8)).astype(np.float32)
        gid = j_adaptive.similarity_group_ids(jnp.asarray(emb), 0.3, 4)
        lens = j_adaptive.group_lengths(gid, 12)
        tgid = torch.as_tensor(np.asarray(gid))
        tlens = t_adaptive.group_lengths(tgid, 12)
        np.testing.assert_array_equal(tlens.numpy(), np.asarray(lens))
        np.testing.assert_array_equal(
            t_adaptive.group_ids_from_lengths(tlens, 12).numpy(),
            np.asarray(j_adaptive.group_ids_from_lengths(lens, 12)))
        groups = rng.standard_normal((2, 12, 5)).astype(np.float32)
        np.testing.assert_array_equal(
            t_adaptive.degroup(torch.as_tensor(groups), tgid).numpy(),
            np.asarray(j_adaptive.degroup(jnp.asarray(groups), gid)))

    def test_inject_extract_exact(self):
        rng = np.random.default_rng(6)
        codes = rng.integers(0, 1024, (2, 5, 4)).astype(np.int32)
        lengths = np.asarray([[1, 3, 8, 2, 0], [4, 4, 4, 0, 0]], np.int32)
        want = j_adaptive.inject_length(jnp.asarray(codes),
                                        jnp.asarray(lengths), 1024)
        got = t_adaptive.inject_length(torch.as_tensor(codes),
                                       torch.as_tensor(lengths), 1024)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jp, jl = j_adaptive.extract_length(want, 1024)
        tp, tl = t_adaptive.extract_length(got, 1024)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tl.numpy(), lengths)


def _port_stack(params, d, layers, heads, ff, **kw):
    """The port's MimiTransformer loaded from a JAX MimiTransformer's
    params through the reference layout."""
    sd = {}
    _inv_mimi_transformer(params, "t", sd)
    m = t_mimi.MimiTransformer(d, layers, heads, ff, **kw)
    m.load_state_dict({k[2:]: torch.as_tensor(v) for k, v in sd.items()})
    return m.eval()


class TestMimi:
    def test_rope_interleaved(self):
        x = np.random.default_rng(7).standard_normal(
            (2, 9, 3, 8)).astype(np.float32)
        want = j_mimi.rope_interleaved(jnp.asarray(x), jnp.arange(9))
        got = t_mimi.rope_interleaved(torch.as_tensor(x), torch.arange(9))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)

    @pytest.mark.parametrize("causal,context,masked", [
        (False, None, False), (False, None, True), (True, None, False),
        (True, 3, True)])
    def test_transformer(self, causal, context, masked):
        """Two Mimi layers: full attention, the key-validity mask, the
        causal mask and the causal mask within ``context``."""
        d, heads, ff, s = 32, 4, 48, 11
        rng = np.random.default_rng(8)
        x = rng.standard_normal((2, s, d)).astype(np.float32)
        valid = np.arange(s)[None] < np.asarray([[s], [7]])
        jm = j_mimi.MimiTransformer(d, 2, heads, ff, causal, context)
        variables = jax.device_get(random_variables(jm, x, valid, seed=9))
        want = jm.apply(variables, x, valid if masked else None)
        port = _port_stack(variables["params"], d, 2, heads, ff,
                           causal=causal, context=context)
        with torch.no_grad():
            got = port(torch.as_tensor(x),
                       torch.as_tensor(valid) if masked else None)
        rows = valid if masked else np.ones_like(valid)
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   **TOL)

    @pytest.mark.parametrize("dims", [(32, 32, 32), (24, 32, 40)])
    def test_projected_transformer(self, dims):
        """Identity projections when the widths match, no-bias
        input/output projections when they do not."""
        inp, d, out = dims
        x = np.random.default_rng(10).standard_normal(
            (1, 7, inp)).astype(np.float32)
        jm = j_mimi.MimiProjectedTransformer(d, inp, out, 1, 4, 48)
        p = jax.device_get(random_variables(jm, x, seed=11))["params"]
        sd = {}
        _inv_mimi_transformer(p["transformer"], "transformer", sd)
        for name in ("input_proj", "output_proj"):
            if name in p:
                sd[f"{name}.weight"] = np.asarray(p[name]["kernel"]).T
        port = t_mimi.MimiProjectedTransformer(d, inp, out, 1, 4, 48)
        port.load_state_dict(to_torch(sd))
        with torch.no_grad():
            got = port(torch.as_tensor(x))
        assert got.shape == (1, 7, out)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jm.apply({"params": p}, x)),
                                   **TOL)


class TestCodec:
    def test_aggregator(self, models):
        """Both aggregators on the codec's latents: groups within 1e-4,
        zero at padding groups, counts exact."""
        cfg, variables, jm, port = models
        wav, feat = _inputs(1)
        emb, sem = jm.apply(variables, wav, feat, method=lambda m, w, f: (
            m.encoder(w), m.semantic_encoder(f)))
        thr = mid_threshold(_sims(sem))
        gid = j_adaptive.similarity_group_ids(sem, thr, cfg.max_group_len)
        for name, x in (("acoustic_aggregator", emb),
                        ("semantic_aggregator", sem)):
            want, wc = j_adaptive.QueryTokenAggregator(
                cfg.base.latent_dim, cfg.aggregator_heads,
                cfg.aggregator_layers, cfg.aggregator_ff).apply(
                    {"params": variables["params"][name]}, x, gid)
            with torch.no_grad():
                got, tc = getattr(port, name)(
                    torch.as_tensor(np.asarray(x)),
                    torch.as_tensor(np.asarray(gid)))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(wc))
            valid = np.asarray(wc) > 0
            assert 1 < valid.sum() < T, "no padding groups"
            np.testing.assert_allclose(got.numpy()[valid],
                                       np.asarray(want)[valid], **TOL)
            assert (got.numpy()[~valid] == 0).all()

    @pytest.mark.parametrize("seed", [1, 2])
    def test_encode_exact_decode_close(self, models, seed):
        """Codes with the lengths injected equal JAX's exactly (the
        similarity margin in the message); the waveform of those codes
        within 1e-4 of its peak."""
        cfg, variables, jm, port = models
        wav, feat = _inputs(seed)
        sem = jm.apply(variables, feat, method=lambda m, f:
                       m.semantic_encoder(f))
        sims = _sims(sem)
        thr = mid_threshold(sims)
        ja, js = jm.apply(variables, wav, feat, method="encode",
                          threshold=thr)
        with torch.no_grad():
            ta, ts = port.encode(torch.as_tensor(wav), torch.as_tensor(feat),
                                 threshold=thr)
        msg = f"min |sim - thr| {margin(sims, thr):.3e}"
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      err_msg=msg)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js),
                                      err_msg=msg)
        lengths = t_adaptive.extract_length(ta, cfg.base.codebook_size)[1]
        assert int(lengths.sum()) == T and (lengths[0, -1] == 0)
        assert len(np.unique(ta.numpy() % cfg.base.codebook_size)) > 3
        want = np.asarray(jm.apply(variables, ja, js, method="decode"))
        with torch.no_grad():
            got = port.decode(ta, ts).numpy()
        assert got.shape == want.shape == (1, L)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    def test_forward_eval_is_decode_of_encode(self, models):
        """``forward(train=False)``'s waveform equals decode(encode) (same
        codebook rows, same bottleneck input) and JAX's forward; its
        predicted features match JAX's."""
        cfg, variables, jm, port = models
        wav, feat = _inputs(3)
        x, f = torch.as_tensor(wav), torch.as_tensor(feat)
        with torch.no_grad():
            recon, pred, commit = port(x, f, train=False)
            rt = port.decode(*port.encode(x, f))
        np.testing.assert_allclose(recon.numpy(), rt.numpy(), atol=1e-6,
                                   rtol=0)
        jr, jp, jc = jm.apply(variables, wav, feat, train=False)
        peak = np.abs(np.asarray(jr)).max()
        assert np.abs(recon.numpy() - np.asarray(jr)).max() <= 1e-4 * peak
        np.testing.assert_allclose(pred.numpy(), np.asarray(jp), **TOL)
        assert float(commit) == float(jc) == 0.0
        with pytest.raises(ValueError, match="trainable=True"):
            port(x, f, train=True)  # the inference model: no EMA state

    def test_thresholds(self, models):
        """The manual threshold overrides the config's; the dynamic mode
        draws uniform in [lower, upper) from the explicit generator, and
        its codes are those of that threshold given by hand (also in
        JAX); the token rate counts the groups."""
        cfg, variables, jm, port = models
        wav, feat = _inputs(4)
        x, f = torch.as_tensor(wav), torch.as_tensor(feat)
        with torch.no_grad():
            low = port.token_rate(x, f, threshold=-1.0)
            high = port.token_rate(x, f, threshold=1.1)
        seconds = L / 16000
        assert float(low[0]) == pytest.approx(-(-T // cfg.max_group_len)
                                              / seconds)
        assert float(high[0]) == pytest.approx(T / seconds)
        np.testing.assert_allclose(low.numpy(), np.asarray(jm.apply(
            variables, wav, feat, method="token_rate", threshold=-1.0)))
        dyn = t_adaptive.AdaptiveHCodec(port_cfg(dataclasses.replace(
            cfg, threshold_mode="dynamic", threshold_lower=0.2,
            threshold_upper=0.6)))
        dyn.load_state_dict(port.state_dict())
        thr = dyn.threshold(generator=torch.Generator().manual_seed(5))
        u = float(torch.rand((), generator=torch.Generator().manual_seed(5)))
        assert thr == pytest.approx(0.2 + u * 0.4) and 0.2 <= thr < 0.6
        with torch.no_grad():
            got = dyn.encode(x, f, generator=torch.Generator().manual_seed(5))
            by_hand = port.encode(x, f, threshold=thr)
        for a, b in zip(got, by_hand):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        ja, _ = jm.apply(variables, wav, feat, method="encode",
                         threshold=np.float32(thr))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ja))


@pytest.fixture(scope="module")
def tokenizers(models):
    cfg, variables, _, port = models
    ssl_cfg = tiny_xlsr_config()
    ssl_vars = jax.device_get(xlsr_variables(ssl_cfg))
    ssl = t_ssl.Wav2Vec2Model(t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg)))
    ssl.load_state_dict(to_torch(t_convert.xlsr_state_dict(ssl_vars,
                                                           ssl_cfg)))
    return (JTokenizer(cfg, variables, ssl_cfg, ssl_vars),
            TTokenizer(port, ssl), ssl_cfg, ssl_vars)


def test_tokenizer_over_xlsr(tokenizers):
    """XLSR features (layers 11, 14, 16, signed |x| ** 0.3) within 1e-4;
    tokenize's codes (B, nq, G) exact and its token rate equal; the
    waveform of detokenize within 1e-4 of its peak."""
    jtok, tok = tokenizers[:2]
    wav = (_inputs(5)[0][..., 0])[:, :L - 100]  # padded to the hop inside
    np.testing.assert_allclose(
        tok.extract_features(tok.pad_wav(torch.as_tensor(wav))).numpy(),
        np.asarray(jtok._features(jtok.pad_wav(jnp.asarray(wav)))), **TOL)
    want = jtok.tokenize(jnp.asarray(wav))
    got = tok.tokenize(torch.as_tensor(wav))
    for key in ("acoustic_codes", "semantic_codes"):
        assert got[key].shape == (1, 2, T)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["token_rate_hz"].numpy(),
                               np.asarray(want["token_rate_hz"]), rtol=1e-6)
    w = np.asarray(jtok.detokenize(want["acoustic_codes"],
                                   want["semantic_codes"]))
    g = tok.detokenize(got["acoustic_codes"], got["semantic_codes"]).numpy()
    assert g.shape == w.shape == (1, L)
    assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_cli_codec_hcodec15_against_jax(models, tokenizers, tmp_path,
                                        monkeypatch, capsys):
    """``main(["codec", "--model", "hcodec15", "--ckpt", SD, "--device",
    "cpu"])`` on the tiny stack against the JAX package's ``cmd_codec`` of
    the same checkpoint and XLSR weights: the same JSON line and the same
    16-bit waveform within one PCM step plus 1e-4 of its peak; without
    ``--ckpt`` the port's random weights from the seed give a finite round
    trip; ``--dtype bfloat16`` is refused."""
    from unified_audio_tpu import cli as j_cli
    from unified_audio_tpu.models.ssl import wav2vec2 as j_ssl

    cfg, variables = models[:2]
    jtok, _, ssl_cfg, ssl_vars = tokenizers
    ckpt = tmp_path / "hcodec15.pt"
    torch.save(to_torch(export_hcodec15_state_dict(variables, cfg)), ckpt)
    n = L - 300
    write_wav(tmp_path / "in.wav", _inputs(6)[0][0, :n, 0], 16000)
    monkeypatch.setattr(j_adaptive, "adaptive15_config", lambda: cfg)
    monkeypatch.setattr(j_ssl, "wav2vec2_large_xlsr53_config",
                        lambda: ssl_cfg)
    monkeypatch.setattr(JTokenizer, "from_random", classmethod(
        lambda c, key, config=None: jtok))
    build = functools.partial(
        cli._build_hcodec15, cfg=port_cfg(cfg),
        ssl_cfg=t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg)))

    def with_xlsr(*args, **kw):  # the JAX run's XLSR weights
        tok = build(*args, **kw)
        tok.ssl.load_state_dict(to_torch(t_convert.xlsr_state_dict(
            ssl_vars, ssl_cfg)))
        return tok

    monkeypatch.setattr(cli, "_build_hcodec15", with_xlsr)
    args = ["codec", "--model", "hcodec15", "--input", str(tmp_path /
                                                          "in.wav")]
    j_cli.main([*args, "--output", str(tmp_path / "j.wav"), "--ckpt",
                str(ckpt)])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jw, _ = read_wav(tmp_path / "j.wav")
    got = cli.main([*args, "--output", str(tmp_path / "j.wav"), "--ckpt",
                    str(ckpt), "--device", "cpu"])
    assert want == got
    assert got["acoustic_shape"] == [1, 2, T]
    assert got["tokens_per_sec"] < T / (n / 16000)  # some groups merged
    tw, fs = read_wav(tmp_path / "j.wav")
    assert fs == 16000 and tw.shape == jw.shape == (1, L)
    # both wavs are 16-bit PCM: one step of it on top of 1e-4 of the peak
    assert np.abs(tw - jw).max() <= 1e-4 * np.abs(jw).max() + 2.0 ** -15
    got = cli.main([*args, "--output", str(tmp_path / "r.wav"), "--device",
                    "cpu"])
    assert got["acoustic_shape"][:2] == [1, 2]
    assert np.isfinite(read_wav(tmp_path / "r.wav")[0]).all()
    with pytest.raises(SystemExit, match="hcodec10 and hcodec20"):
        cli.main([*args, "--output", str(tmp_path / "b.wav"), "--dtype",
                  "bfloat16", "--device", "cpu"])
