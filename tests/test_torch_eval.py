"""The port's evaluation models (``unified_audio_tpu_torch.eval``: the
metrics copy, SPK-SIM through BiCodec's speaker encoder, learned UTMOS)
and the codec round-trip scorer ``roundtrip_codec_eval`` against the JAX
package's ``unified_audio_tpu.eval`` on the CPU;
tests/test_torch_eval_runner.py holds ``evaluate`` and ``cli eval``.

Every copied metric equals JAX's on the same arrays (1e-9; ``mcd``, whose
mel spectrogram is the port's torch one, 1e-5). The speaker embeddings and
UTMOS scores, and the round trip's summary on the tiny HCodec-1.0, agree
within 1e-4.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_common import (bicodec_variables, to_torch,
                               tiny_tokenizer_config)
from test_torch_hcodec import _wav, seeded_models, small10
from unified_audio_tpu.eval import metrics as jm
from unified_audio_tpu.eval import runner as jrunner
from unified_audio_tpu.eval.utmos import (UTMOSConfig, UTMOSPredictor,
                                          export_utmos_state_dict)
from unified_audio_tpu.models.bicodec.bicodec import BiCodec
from unified_audio_tpu.models.ssl import wav2vec2 as j_ssl
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.eval import metrics as tm
from unified_audio_tpu_torch.eval import runner as trunner
from unified_audio_tpu_torch.eval import utmos as tutmos
from unified_audio_tpu_torch.models.bicodec import bicodec as t_bicodec
from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl
from unified_audio_tpu_torch.utils import convert as t_convert

FS = 16000


def _speechlike(n=16000, fs=FS, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = sum(np.sin(2 * np.pi * f * t) / (i + 1)
            for i, f in enumerate((220, 440, 660, 880)))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _pair(fs=FS, n=16000, lag=0):
    ref = _speechlike(n, fs)
    est = 0.8 * np.roll(ref, lag) + 0.05 * np.random.default_rng(
        1).standard_normal(n).astype(np.float32)
    return est.astype(np.float32), ref


METRICS = {
    "si_snr": lambda m: m.si_snr(*_pair()),
    "lsd": lambda m: m.lsd(*_pair()),
    "stoi": lambda m: m.stoi(*_pair(), FS),
    "stoi_8k": lambda m: m.stoi(*_pair(8000, 8000), 8000),
    "pesq_aligned": lambda m: m.pesq(*_pair(), FS, assume_aligned=True),
    "pesq_alignment_search": lambda m: m.pesq(*_pair(lag=37), FS),
    "pesq_narrowband_irs": lambda m: m.pesq(*_pair(8000, 8000), 8000),
    "pesq_mos_lqo": lambda m: m.pesq_mos_lqo(2.7),
    "utmos_proxy": lambda m: m.utmos_proxy(_pair()[0], FS),
    "utmos_without_predictor": lambda m: m.utmos(_pair()[0], FS)[0],
    "wer": lambda m: m.wer("the cat sat on a mat", "the cat sat on the mat"),
    "spk_sim": lambda m: m.spk_sim(np.arange(8.0) - 3, np.ones(8)),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_equals_jax(name):
    got, want = METRICS[name](tm), METRICS[name](jm)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_mcd_equals_jax():
    est, ref = _pair()
    np.testing.assert_allclose(tm.mcd(est, ref, FS), jm.mcd(est, ref, FS),
                               rtol=1e-5, atol=1e-5)


def test_utmos_reports_its_variant():
    assert tm.utmos(_pair()[0], FS)[1] == "utmos_proxy"
    assert tm.utmos(_pair()[0], FS, predictor=lambda w: 3.5) == (
        3.5, "utmos_learned")


def test_spk_embed_fn_equals_jax():
    cfg = tiny_tokenizer_config()
    variables = jax.device_get(bicodec_variables(cfg))
    model = t_bicodec.BiCodec(t_bicodec.BiCodecConfig(
        **dataclasses.asdict(cfg)), tokenize=True)
    model.load_state_dict(to_torch(t_convert.bicodec_state_dict(variables,
                                                                cfg)))
    got_fn = tm.make_spk_embed_fn(model.eval())
    want_fn = jm.make_spk_embed_fn(BiCodec(cfg), variables)
    for n in (9000, 170000):  # tiled up to, and cropped to, the window
        wav = _speechlike(n)[None]
        got, want = got_fn(wav), np.asarray(want_fn(wav))
        assert got.shape == want.shape == (cfg.spk_out_dim,)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _tiny_hubert():
    return j_ssl.SSLConfig(
        hidden_size=16, num_layers=2, num_heads=4, intermediate_size=16,
        conv_dim=(8,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4)


UTMOS_CFG = dict(ssl_dim=16, judge_dim=8, domain_dim=8, num_judges=5,
                 num_domains=2, blstm_hidden=8, mlp_hidden=16)


@functools.lru_cache(maxsize=None)
def _utmos():
    """JAX's tiny UTMOS predictor (the biases made non-zero) and its
    state dict: the head in the canonical layout, the HuBERT as
    ``ssl_model.*`` in the HF layout."""
    pred = UTMOSPredictor.from_random(jax.random.PRNGKey(1),
                                      ssl_config=_tiny_hubert(),
                                      cfg=UTMOSConfig(**UTMOS_CFG))
    rng = np.random.default_rng(3)
    pred.head_variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.standard_normal(
            np.shape(x)).astype(np.float32), jax.device_get(
                pred.head_variables))
    sd = dict(export_utmos_state_dict(pred.head_variables))
    for k, v in t_convert.hubert_state_dict(
            jax.device_get(pred.ssl_variables), _tiny_hubert()).items():
        sd[f"ssl_model.{k}"] = v
    return pred, {k: torch.as_tensor(np.ascontiguousarray(v))
                  for k, v in sd.items()}


def _port_utmos(path):
    return cli._build_utmos(
        path, "cpu", cfg=tutmos.UTMOSConfig(**UTMOS_CFG),
        ssl_cfg=t_ssl.SSLConfig(**dataclasses.asdict(_tiny_hubert())))


@pytest.mark.parametrize("layout", ["canonical", "utmos22"])
def test_utmos_predictor_equals_jax(tmp_path, layout):
    """Loaded from JAX's ``export_utmos_state_dict`` (or the same weights
    under the released UTMOS22 Lightning names, the positional conv as
    weight norm), the port scores JAX's score."""
    pred, sd = _utmos()
    if layout == "utmos22":
        names = {"domain_embedding.weight":
                 "feature_extractors.1.embedding.weight",
                 "judge_embedding.weight":
                 "output_layers.0.judge_embedding.weight",
                 "linear1.weight": "output_layers.1.net.0.weight",
                 "linear1.bias": "output_layers.1.net.0.bias",
                 "linear2.weight": "output_layers.1.net.3.weight",
                 "linear2.bias": "output_layers.1.net.3.bias"}
        sd = {("model." + names.get(k, k).replace(
            "blstm.", "output_layers.0.decoder_rnn.")
               if not k.startswith("ssl_model.") else k): v
              for k, v in sd.items()}
        conv = "ssl_model.encoder.pos_conv_embed.conv"
        w = sd.pop(f"{conv}.weight")
        g = w.square().sum((0, 1), keepdim=True).sqrt()
        sd[f"{conv}.weight_g"], sd[f"{conv}.weight_v"] = g, w * 2.0
    torch.save(sd, tmp_path / "utmos.pt")
    port = _port_utmos(tmp_path / "utmos.pt")
    for seed in (0, 1):
        wav = 0.2 * np.random.default_rng(seed).standard_normal(
            8000).astype(np.float32)
        np.testing.assert_allclose(port(wav), pred(wav), rtol=1e-4,
                                   atol=1e-4)


def _assert_summaries_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_roundtrip_codec_eval_equals_jax(tmp_path):
    cfg, _, _, _, jtok, ttok = seeded_models(small10(), 640 * 8)
    paths = []
    for i, n in enumerate((640 * 8, 640 * 6)):
        paths.append(tmp_path / f"c{i}.wav")
        write_wav(paths[-1], _wav(20 + i, n)[0], FS)
    got = trunner.roundtrip_codec_eval(ttok, paths)
    want = jrunner.roundtrip_codec_eval(jtok, paths)
    assert "mcd" in got and "utmos_proxy" in got
    _assert_summaries_close(got, want)
