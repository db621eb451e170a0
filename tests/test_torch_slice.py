"""The whole slice: the port's ``serve`` (JSONL requests -> WavLM frontend
-> paged-KV engine -> BiCodec) against the JAX package's offline
``UniSE.enhance_se`` / ``enhance_tse`` on a tiny UniSE stack.

Greedy requests of two 0.4-s segments each outnumber the engine's two
slots. The LM runs in fp32 here (the serving default is bf16). Tokens must
be identical; waveforms within atol/rtol 1e-4.
"""
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_common import TOL, port_unise, tiny_unise_jax
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav


@pytest.fixture(scope="module")
def stacks():
    unise = tiny_unise_jax()
    return unise, port_unise(unise)


def _record(obj, store):
    """Wrap obj._decode_tokens to record the tokens and waveform."""
    inner = obj._decode_tokens

    def wrapped(g, s, orig_len):
        est = inner(g, s, orig_len)
        store.append((np.asarray(g), np.asarray(s), np.asarray(est)))
        return est

    obj._decode_tokens = wrapped


def _write_requests(tmp_path, lines):
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(l) for l in lines))
    return path


def test_serve_matches_offline_enhance(stacks, tmp_path):
    unise, tunise = stacks
    rng = np.random.default_rng(0)
    mixes = [(0.2 * rng.standard_normal(9600)).astype(np.float32)
             for _ in range(2)]
    enroll = (0.3 * rng.standard_normal(5000)).astype(np.float32)
    for i, m in enumerate(mixes):
        write_wav(tmp_path / f"mix{i}.wav", m, 16000)
    write_wav(tmp_path / "enroll.wav", enroll, 16000)
    lines = [
        {"task": "se", "mix": str(tmp_path / "mix0.wav"),
         "output": str(tmp_path / "out0.wav"), "do_sample": False},
        {"task": "tse", "mix": str(tmp_path / "mix1.wav"),
         "enroll": str(tmp_path / "enroll.wav"),
         "output": str(tmp_path / "out1.wav"), "do_sample": False},
    ]
    got = []
    _record(tunise, got)
    summary = cli.serve(_write_requests(tmp_path, lines), tunise, slots=2,
                        lm_dtype=torch.float32)
    assert summary["segments"] == 4
    assert summary["engine_stats"]["requests_completed"] == 4

    want = []
    _record(unise, want)
    mix0, _ = read_wav(tmp_path / "mix0.wav")
    mix1, _ = read_wav(tmp_path / "mix1.wav")
    e, _ = read_wav(tmp_path / "enroll.wav")
    unise.enhance_se(mix0, jax.random.PRNGKey(0), do_sample=False)
    unise.enhance_tse(mix1, e / np.abs(e).max(), jax.random.PRNGKey(0),
                      do_sample=False)
    for (tg, ts, tw), (jg, js, jw) in zip(got, want):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(ts, js)
        assert tw.shape == jw.shape == (9600,)
        np.testing.assert_allclose(tw, jw, **TOL)
    out, fs = read_wav(tmp_path / "out0.wav")
    assert fs == 16000 and out.shape == (1, 9600)


def test_cli_serve_bf16_end_to_end(stacks, tmp_path, monkeypatch):
    """``main(["serve", ...])``: bf16 LM, int8 pool, sampled and greedy
    lines; outputs are finite and of the input's length."""
    tunise = port_unise(stacks[0])  # its own copy: serve casts the LM
    monkeypatch.setattr(cli, "_build_unise", lambda ckpt=None, device="cpu":
                        tunise)
    wav = (0.2 * np.random.default_rng(1).standard_normal(7000)).astype(
        np.float32)
    write_wav(tmp_path / "mix.wav", wav, 16000)
    lines = [{"task": "rtse", "mix": str(tmp_path / "mix.wav"),
              "enroll": str(tmp_path / "mix.wav"),
              "output": str(tmp_path / "a.wav"), "top_k": 5},
             {"task": "se", "mix": str(tmp_path / "mix.wav"),
              "output": str(tmp_path / "b.wav"), "do_sample": False}]
    summary = cli.main(["serve", "--requests",
                        str(_write_requests(tmp_path, lines)),
                        "--slots", "2", "--kv-quant", "int8",
                        "--device", "cpu"])
    assert summary["engine_stats"]["requests_completed"] == 4
    for name in ("a.wav", "b.wav"):
        out, fs = read_wav(tmp_path / name)
        assert fs == 16000 and out.shape == (1, 7000)
        assert np.isfinite(out).all()


@pytest.mark.parametrize("line", [
    {"task": "ss", "mix": "missing.wav", "output": "o.wav"},
    {"task": "tse", "mix": "MIX", "output": "o.wav"},
    {"task": "se", "mix": "missing.wav", "output": "o.wav"},
    {"task": "xx", "mix": "MIX", "output": "o.wav"}])
def test_serve_rejects_bad_requests(tmp_path, line):
    write_wav(tmp_path / "mix.wav", np.zeros(100, np.float32), 16000)
    line = {k: (str(tmp_path / "mix.wav") if v == "MIX" else v)
            for k, v in line.items()}
    with pytest.raises(SystemExit):
        cli.main(["serve", "--requests",
                  str(_write_requests(tmp_path, [line])), "--device", "cpu"])


def test_serve_missing_request_file(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["serve", "--requests", str(tmp_path / "nope.jsonl"),
                  "--device", "cpu"])


@pytest.mark.parametrize("cmd", ["serve", "codec"])
def test_entry_points_need_a_card_unless_asked_for_cpu(tmp_path, monkeypatch,
                                                       cmd):
    """Without a card and without ``--device cpu``, ``serve`` and ``codec``
    exit non-zero before building a model, naming the flag."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_wav(tmp_path / "mix.wav", np.zeros(1600, np.float32), 16000)
    built = []
    monkeypatch.setattr(cli, "_build_unise", lambda **kw: built.append(kw))
    monkeypatch.setattr(cli, "_build_hcodec",
                        lambda *a, **kw: built.append(kw))
    argv = (["serve", "--requests", str(_write_requests(tmp_path, [
        {"task": "se", "mix": str(tmp_path / "mix.wav"),
         "output": str(tmp_path / "o.wav")}]))] if cmd == "serve" else
            ["codec", "--input", str(tmp_path / "mix.wav"), "--output",
             str(tmp_path / "o.wav")])
    with pytest.raises(SystemExit) as exit_info:
        cli.main(argv)
    assert exit_info.value.code not in (0, None)
    assert "--device cpu" in str(exit_info.value.code)
    assert not built
