"""FlexiCodec's semantic teacher in the port (``unified_audio_tpu_torch``)
against the JAX package on the CPU: the Kaldi fbank frontend
(``ops/fbank.py``: mel banks, fbank, LFR, CMVN) and the SenseVoice SAN-M
encoder (``models/ssl/sanm.py``) at a tiny configuration, loaded from a
funasr-layout state dict.

The funasr layout comes from :func:`funasr_state_dict`, the inverse of the
JAX package's ``convert_sensevoice``, held to it by a round trip. Tolerances:
mel banks and LFR exact; fbank, CMVN, SAN-M layers and the teacher's
semantic stream within atol/rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables, to_torch
from unified_audio_tpu.models.hcodec import flexicodec as j_flexi
from unified_audio_tpu.models.ssl import sanm as j_sanm
from unified_audio_tpu.ops import fbank as j_fbank
from unified_audio_tpu.utils.convert import convert_sensevoice
from unified_audio_tpu_torch.models.hcodec import flexicodec as t_flexi
from unified_audio_tpu_torch.models.ssl import sanm as t_sanm
from unified_audio_tpu_torch.ops import fbank as t_fbank
from unified_audio_tpu_torch.utils import convert as t_convert


def tiny_sanm_config(**kw):
    base = dict(input_size=24, output_size=16, attention_heads=2,
                linear_units=32, num_blocks=3, tp_blocks=2, kernel_size=5)
    base.update(kw)
    return j_sanm.SANMConfig(**base)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _funasr_layer(p, prefix, out):
    for n in ("norm1", "norm2"):
        out[f"{prefix}.{n}.weight"] = np.asarray(p[n]["scale"])
        out[f"{prefix}.{n}.bias"] = np.asarray(p[n]["bias"])
    for ours, theirs in (("linear_q_k_v", "self_attn.linear_q_k_v"),
                         ("linear_out", "self_attn.linear_out")):
        out[f"{prefix}.{theirs}.weight"] = np.asarray(
            p["self_attn"][ours]["kernel"]).T
        out[f"{prefix}.{theirs}.bias"] = np.asarray(
            p["self_attn"][ours]["bias"])
    out[f"{prefix}.self_attn.fsmn_block.weight"] = np.asarray(
        p["self_attn"]["fsmn_kernel"]).T[:, None, :]
    for ours, theirs in (("ff_w1", "w_1"), ("ff_w2", "w_2")):
        out[f"{prefix}.feed_forward.{theirs}.weight"] = np.asarray(
            p[ours]["kernel"]).T
        out[f"{prefix}.feed_forward.{theirs}.bias"] = np.asarray(
            p[ours]["bias"])


def funasr_state_dict(variables, cfg, extra=True):
    """``SenseVoiceSemanticEncoder`` variables -> funasr's SenseVoiceSmall
    layout (the inverse of ``convert_sensevoice``); ``extra`` adds keys of
    the ASR head that the teacher does not read."""
    p = variables["params"]
    enc, out = p["encoder"], {}
    _funasr_layer(enc["encoders0_0"], "encoder.encoders0.0", out)
    for name, n in (("encoders", cfg.num_blocks - 1),
                    ("tp_encoders", cfg.tp_blocks)):
        for i in range(n):
            _funasr_layer(_index(enc[name]["layer"], i),
                          f"encoder.{name}.{i}", out)
    for n in ("after_norm", "tp_norm"):
        out[f"encoder.{n}.weight"] = np.asarray(enc[n]["scale"])
        out[f"encoder.{n}.bias"] = np.asarray(enc[n]["bias"])
    out["embed.weight"] = np.asarray(p["query_embed"])
    if extra:
        out["ctc.ctc_lo.weight"] = np.zeros((7, cfg.output_size), np.float32)
    return out


def sanm_variables(cfg, seed=0):
    return jax.device_get(random_variables(
        j_sanm.SenseVoiceSemanticEncoder(cfg),
        np.zeros((1, 9, cfg.input_size), np.float32), seed=seed))


def port_teacher(cfg, variables):
    m = t_sanm.SenseVoiceSemanticEncoder(
        t_sanm.SANMConfig(**dataclasses.asdict(cfg)))
    m.load_state_dict(to_torch(t_convert.sensevoice_keys(
        funasr_state_dict(variables, cfg), cfg)))
    return m.eval()


def write_cmvn(path, dim, seed=0):
    """A synthetic Kaldi nnet CMVN file (``am.mvn``) of ``dim`` entries:
    shifts of about minus a log-mel mean, rescales of about one over its
    spread."""
    rng = np.random.default_rng(seed)
    add = -(12.0 + rng.standard_normal(dim))
    scale = 0.3 + 0.05 * rng.random(dim)

    def row(v):
        return " ".join(f"{x:.6f}" for x in v)

    path.write_text(
        f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n"
        f"<AddShift> {dim} {dim}\n<LearnRateCoef> 0 [ {row(add)} ]\n"
        f"<Rescale> {dim} {dim}\n<LearnRateCoef> 0 [ {row(scale)} ]\n"
        "</Nnet>\n")
    return path


def _speech(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


class TestFbank:
    def test_mel_banks_exact(self):
        np.testing.assert_array_equal(
            t_fbank.kaldi_mel_banks(80, 512, 16000.0),
            j_fbank.kaldi_mel_banks(80, 512, 16000.0))

    @pytest.mark.parametrize("n", [400, 4321, 16000])
    def test_kaldi_fbank(self, n):
        """Hamming, pre-emphasis, DC removal, the 512-point power spectrum,
        the log floor: within 1e-4 over a batch of two."""
        wav = np.stack([_speech(n, n), 0.5 * _speech(n + 1, n)])
        want = np.asarray(j_fbank.kaldi_fbank(jnp.asarray(wav)))
        got = t_fbank.kaldi_fbank(torch.as_tensor(wav)).numpy()
        assert got.shape == want.shape == (2, 1 + (n - 400) // 160, 80)
        np.testing.assert_allclose(got, want, **TOL)

    def test_fbank_floor_and_dither(self):
        """Silence hits the float32-eps log floor as in JAX; dither draws
        from the explicit generator (the same seed, the same features) and
        needs one."""
        silent = np.zeros((1, 800), np.float32)
        np.testing.assert_allclose(
            t_fbank.kaldi_fbank(torch.as_tensor(silent)).numpy(),
            np.asarray(j_fbank.kaldi_fbank(jnp.asarray(silent))), **TOL)
        x = torch.as_tensor(_speech(3, 1600))
        a, b = (t_fbank.kaldi_fbank(x, dither=1.0, generator=torch.Generator(
        ).manual_seed(0)) for _ in range(2))
        assert torch.equal(a, b) and not torch.equal(a, t_fbank.kaldi_fbank(x))
        with pytest.raises(ValueError, match="generator"):
            t_fbank.kaldi_fbank(x, dither=1.0)

    @pytest.mark.parametrize("t", [1, 5, 6, 7, 13, 98])
    def test_apply_lfr_exact(self, t):
        """The left pad of (m - 1) // 2 copies of frame 0, windows of 7 at
        stride 6, the tail repeating the last frame."""
        feats = np.random.default_rng(t).standard_normal(
            (2, t, 4)).astype(np.float32)
        want = np.asarray(j_fbank.apply_lfr(jnp.asarray(feats)))
        got = t_fbank.apply_lfr(torch.as_tensor(feats)).numpy()
        assert got.shape == (2, -(-t // 6), 28)
        np.testing.assert_array_equal(got, want)

    def test_cmvn_parse_apply(self, tmp_path):
        path = write_cmvn(tmp_path / "am.mvn", 560)
        add, scale = t_fbank.load_kaldi_cmvn(str(path))
        jadd, jscale = j_fbank.load_kaldi_cmvn(str(path))
        np.testing.assert_array_equal(add, jadd)
        np.testing.assert_array_equal(scale, jscale)
        x = np.random.default_rng(1).standard_normal(
            (2, 3, 560)).astype(np.float32)
        np.testing.assert_allclose(
            t_fbank.apply_cmvn(torch.as_tensor(x), add, scale).numpy(),
            np.asarray(j_fbank.apply_cmvn(jnp.asarray(x), jadd, jscale)),
            **TOL)
        bad = tmp_path / "bad.mvn"
        bad.write_text("<AddShift> 4 4\n<LearnRateCoef> 0 [ 1 2 3 4 ]\n"
                       "<Rescale> 4 4\n<LearnRateCoef> 0 [ 1 1 1 1 ]\n")
        with pytest.raises(ValueError, match="CMVN dim"):
            t_fbank.SenseVoiceFrontend(cmvn_file=str(bad))
        with pytest.raises(ValueError, match="Rescale"):
            bad.write_text("<AddShift> 1 1\n[ 1 ]\n")
            t_fbank.load_kaldi_cmvn(str(bad))

    def test_frontend(self, tmp_path):
        """fbank + LFR + CMVN of one second: (17, 560) within 1e-4."""
        path = str(write_cmvn(tmp_path / "am.mvn", 560))
        wav = _speech(4, 16000)
        want = np.asarray(j_fbank.SenseVoiceFrontend(cmvn_file=path)(
            jnp.asarray(wav)))
        front = t_fbank.SenseVoiceFrontend(cmvn_file=path)
        got = front(torch.as_tensor(wav)).numpy()
        assert front.output_dim == 560 and got.shape == want.shape == (17,
                                                                      560)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def teacher():
    cfg = tiny_sanm_config()
    variables = sanm_variables(cfg)
    return cfg, variables, port_teacher(cfg, variables)


class TestSANM:
    def test_funasr_layout_round_trip(self, teacher):
        """The helper's funasr state dict converts back, through the JAX
        package's ``convert_sensevoice``, to the same variables; the port
        loads it strictly through ``sensevoice_keys`` (the ASR head left
        out)."""
        cfg, variables, _ = teacher
        sd = funasr_state_dict(variables, cfg)
        back = convert_sensevoice(sd, cfg)
        flat = jax.tree_util.tree_leaves_with_path(variables)
        again = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat) == len(again)
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(again[path]),
                                          np.asarray(leaf))
        keys = t_convert.sensevoice_keys(sd, cfg)
        assert "ctc.ctc_lo.weight" not in keys
        assert set(keys) == set(t_sanm.SenseVoiceSemanticEncoder(
            t_sanm.SANMConfig(**dataclasses.asdict(cfg))).state_dict())

    @pytest.mark.parametrize("first", [True, False])
    def test_layer(self, teacher, first):
        """``encoders0`` (24 -> 16, no attention residual) and a 16 -> 16
        layer, with a key mask: the masked rows' outputs within 1e-4."""
        cfg, variables, port = teacher
        enc = variables["params"]["encoder"]
        p = enc["encoders0_0"] if first else _index(enc["encoders"]["layer"],
                                                    1)
        size = cfg.input_size if first else cfg.output_size
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 9, size)).astype(np.float32)
        mask = (np.arange(9)[None] < np.asarray([[9], [6]])).astype(
            np.float32)
        want = j_sanm.SANMLayer(
            cfg.output_size, cfg.attention_heads, cfg.linear_units,
            cfg.kernel_size, in_size=size).apply({"params": p}, x, mask)
        layer = (port.encoder.encoders0[0] if first
                 else port.encoder.encoders[1])
        with torch.no_grad():
            got = layer(torch.as_tensor(x), torch.as_tensor(mask))
        keep = mask.astype(bool)
        np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                                   **TOL)

    def test_encoder_outputs(self, teacher):
        """encoder_out (after the tp layers), hidden_out and the trunk's
        per-layer outputs within 1e-4."""
        cfg, variables, port = teacher
        x = np.random.default_rng(3).standard_normal(
            (2, 11, cfg.input_size)).astype(np.float32)
        want = j_sanm.SANMEncoder(cfg).apply(
            {"params": variables["params"]["encoder"]}, x)
        with torch.no_grad():
            got = port.encoder(torch.as_tensor(x))
        assert got[2].shape == (cfg.num_blocks, 2, 11, cfg.output_size)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    @pytest.mark.parametrize("layer_mean", [None, (1, 3)])
    def test_semantic_encoder(self, teacher, layer_mean):
        """The 4 query frames prepended and stripped, padded rows masked
        by ``lengths``: the valid rows within 1e-4."""
        cfg, variables, port = teacher
        x = np.random.default_rng(4).standard_normal(
            (2, 9, cfg.input_size)).astype(np.float32)
        lengths = np.asarray([9, 5], np.int32)
        want = np.asarray(j_sanm.SenseVoiceSemanticEncoder(
            cfg, layer_mean=layer_mean).apply(variables, x, lengths))
        port.layer_mean = layer_mean
        try:
            with torch.no_grad():
                got = port(torch.as_tensor(x),
                           torch.as_tensor(lengths)).numpy()
        finally:
            port.layer_mean = None
        assert got.shape == want.shape == (2, 9, cfg.output_size)
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


@pytest.mark.parametrize("out_dim", [None, 40])
def test_sensevoice_teacher_semantic(tmp_path, out_dim):
    """The whole teacher from raw audio (frontend -> SAN-M trunk -> the
    queries stripped), at its 560-wide input, optionally tiled to
    ``out_dim``: within 1e-4 of the JAX package's."""
    cfg = tiny_sanm_config(input_size=560)
    variables = sanm_variables(cfg, seed=5)
    path = str(write_cmvn(tmp_path / "am.mvn", 560))
    wav = np.stack([_speech(6, 8000), _speech(7, 8000)])
    want = np.asarray(j_flexi.sensevoice_teacher_semantic(
        variables, jnp.asarray(wav), path, config=cfg, out_dim=out_dim))
    got = t_flexi.sensevoice_teacher_semantic(
        port_teacher(cfg, variables), torch.as_tensor(wav), path,
        out_dim=out_dim).numpy()
    assert got.shape == want.shape == (2, 8, out_dim or cfg.output_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_sensevoice_semantic_parses_cmvn_once(tmp_path, monkeypatch):
    """The frontend alone, tiled to 600 wide, called twice on one CMVN
    file: the file is parsed once, and each call is within 1e-4 of the
    JAX package's."""
    path = str(write_cmvn(tmp_path / "am.mvn", 560))
    parses = []
    load = t_fbank.load_kaldi_cmvn

    def counting(p):
        parses.append(p)
        return load(p)

    monkeypatch.setattr(t_fbank, "load_kaldi_cmvn", counting)
    wav = np.stack([_speech(8, 8000), _speech(9, 8000)])
    want = np.asarray(j_flexi.sensevoice_semantic(jnp.asarray(wav), path,
                                                  out_dim=600))
    for _ in range(2):
        got = t_flexi.sensevoice_semantic(torch.as_tensor(wav), path,
                                          out_dim=600).numpy()
        assert got.shape == want.shape == (2, 8, 600)
        np.testing.assert_allclose(got, want, **TOL)
    assert parses == [path]


def test_sinusoidal_pe():
    np.testing.assert_allclose(t_sanm.sinusoidal_pe(13, 24).numpy(),
                               np.asarray(j_sanm.sinusoidal_pe(13, 24)),
                               atol=0, rtol=0)
