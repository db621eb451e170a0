"""The SS cascade of the port against the JAX package's offline
``UniSE.separate_ss`` on the tiny UniSE stack of tests/test_torch_slice.py
(0.4-s segments), greedy.

The port's ``SSCascadeRunner`` through the engine (two slots, fp32 LM, so
the cascade's requests queue), the port's offline ``separate_ss`` and
``cli serve`` with an "ss" line must give s1/s2 tokens identical to JAX's;
the waveforms, BiCodec's decode of those tokens, within atol/rtol 1e-4
(``TOL``, as tests/test_torch_slice.py holds the same decode). Regular traffic rides phase 1, and
phase 2's enrollment rows are tensors on the engine's device, admitted as
they are.
"""
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_common import TOL, port_unise, tiny_unise_jax
from test_torch_slice import _record
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav
from unified_audio_tpu_torch.serve.cascade import SSCascadeRunner
from unified_audio_tpu_torch.serve.engine import Request


def _assert_same_tokens(got, want):
    """got/want: [(global, semantic, wav)] per decode; tokens exact, the
    waveforms within ``TOL``."""
    assert len(got) == len(want)
    for (tg, ts, tw), (jg, js, jw) in zip(got, want):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(ts, js)
        assert tw.shape == jw.shape
        np.testing.assert_allclose(tw, jw, **TOL)


def _mix(seed, n):
    return (0.3 * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)[None]


@pytest.fixture(scope="module")
def stacks():
    unise = tiny_unise_jax()
    return unise, port_unise(unise)


@pytest.fixture(scope="module")
def offline(stacks):
    """JAX separate_ss of a 1.5-segment mix (wrap-padded to two): its SE,
    s1 and s2 decodes."""
    unise = stacks[0]
    wav = _mix(0, 9600)
    want = []
    _record(unise, want)
    try:
        unise.separate_ss(wav, jax.random.PRNGKey(0), do_sample=False)
    finally:
        del unise._decode_tokens
    return wav, want


@pytest.fixture(scope="module")
def served(stacks, offline):
    """The port's cascade of the same mix through a two-slot engine, with
    the requests and results of each engine run recorded."""
    tunise = stacks[1]
    wav = offline[0]
    eng = cli.make_engine(tunise, 2)
    runs = []
    inner = eng.run

    def recording(reqs, generator=None):
        runs.append((list(reqs), inner(reqs, generator)))
        return runs[-1][1]

    eng.run = recording
    runner = SSCascadeRunner(eng, tunise)
    req = runner.make(wav, uid=7, do_sample=False)
    results, extra = runner.run([req])
    got = []
    _record(tunise, got)
    try:
        s1, s2 = runner.assemble(req, results[7])
    finally:
        del tunise._decode_tokens
    return eng, runner, req, results, extra, runs, got, (s1, s2)


def test_cascade_tokens_equal_jax_separate_ss(offline, served):
    """Phase 1's SE tokens, then s1 (TSE) and s2 (rTSE) over both
    segments, equal JAX's; the waveforms have the input's length."""
    _, want = offline
    eng, runner, req, results, extra, runs, got, (s1, s2) = served
    assert req.seg_feats.shape[0] == 2 and extra == {}
    _assert_same_tokens(got, want[1:])
    assert s1.shape == s2.shape == (9600,)
    assert eng.stats()["requests_completed"] == 1 + 2 * 2


def test_cascade_se_phase_equals_jax(offline, served):
    """Phase 1 is the one SE request on the first segment, and its tokens
    are JAX's first decode of separate_ss."""
    _, want = offline
    runner, runs = served[1], served[5]
    (se,), out = runs[0]
    assert se.task_id == 0 and se.uid == runner._sub_uid(7, 0, 0)
    np.testing.assert_array_equal(out[se.uid].global_ids, want[0][0][0])
    np.testing.assert_array_equal(out[se.uid].semantic_ids, want[0][1][0])


def test_phase2_enroll_rows_are_device_tensors(served):
    """Every TSE/rTSE request points at the one enrollment tensor of its
    cascade, on the engine's device (exact-segment WavLM features, F
    frames, not padded to the bucket); the mixes are device rows too."""
    eng, runner, req, _, _, runs, _, _ = served
    phase2 = runs[1][0]
    assert [r.task_id for r in phase2] == [1, 1, 2, 2]
    rows = phase2[0].enroll_feats
    assert torch.is_tensor(rows) and rows.device == eng.device
    assert rows.shape == (runner.frames, eng.sft.feats_dim)
    assert all(r.enroll_feats is rows for r in phase2)
    assert all(torch.is_tensor(r.mix_feats) and r.mix_feats.device
               == eng.device for r in phase2)
    assert [r.uid for r in phase2] == [runner._sub_uid(7, p, i)
                                       for p in (1, 2) for i in (0, 1)]


def test_engine_refuses_features_on_another_device(served):
    eng = served[0]
    req = Request(task_id=0, mix_feats=torch.zeros(20, 24, device="meta"),
                  global_length=4, semantic_length=20, do_sample=False)
    with pytest.raises(ValueError, match="meta"):
        eng.validate(req)


def test_offline_separate_ss_equals_jax(stacks, offline):
    """The port's offline separate_ss decodes as JAX's does: SE, s1, s2."""
    tunise = stacks[1]
    wav, want = offline
    got = []
    _record(tunise, got)
    try:
        s1, s2 = tunise.separate_ss(wav, do_sample=False)
    finally:
        del tunise._decode_tokens
    _assert_same_tokens(got, want)
    assert s1.shape == s2.shape == (9600,)


def test_extra_traffic_rides_phase1(stacks, served):
    """A regular SE request passed as ``extra`` comes back in
    extra_results, equal to its solo run; the cascade's tokens do not
    change; a uid that collides with a cascade's SE request is refused."""
    tunise = stacks[1]
    req, results = served[2], served[3]
    rider = Request(task_id=0, mix_wav=_mix(1, 6400)[0], global_length=4,
                    semantic_length=20, do_sample=False, uid=999)
    runner = SSCascadeRunner(cli.make_engine(tunise, 2), tunise)
    got, extra = runner.run([req], extra=[rider])
    assert set(got) == {7} and set(extra) == {999}
    solo = cli.make_engine(tunise, 2).run([rider])[999]
    np.testing.assert_array_equal(extra[999].global_ids, solo.global_ids)
    np.testing.assert_array_equal(extra[999].semantic_ids, solo.semantic_ids)
    for a, b in zip(got[7].s1 + got[7].s2, results[7].s1 + results[7].s2):
        np.testing.assert_array_equal(a.global_ids, b.global_ids)
        np.testing.assert_array_equal(a.semantic_ids, b.semantic_ids)
    clash = Request(task_id=0, mix_wav=rider.mix_wav, global_length=4,
                    semantic_length=20, uid=runner._sub_uid(7, 0, 0))
    with pytest.raises(ValueError, match="collide"):
        runner.run([req], extra=[clash])


def test_cli_serve_ss_line(stacks, tmp_path):
    """``serve`` (fp32 LM) with an "ss" line at 48 kHz (resampled) beside
    an SE line: ``<stem>_s1.wav`` and ``<stem>_s2.wav`` of the resampled
    input's length, listed in the summary, their tokens JAX separate_ss's
    on the same 16 kHz input; an "ss" line whose mix is missing is
    refused."""
    unise, tunise = stacks
    write_wav(tmp_path / "ss.wav", _mix(2, 3 * 8000)[0], 48000)  # 0.5 s
    write_wav(tmp_path / "se.wav", _mix(3, 5000)[0], 16000)
    lines = [{"task": "ss", "mix": str(tmp_path / "ss.wav"),
              "output": str(tmp_path / "sep.wav"), "do_sample": False},
             {"task": "se", "mix": str(tmp_path / "se.wav"),
              "output": str(tmp_path / "se_out.wav"), "do_sample": False}]
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(l) for l in lines))
    got = []
    _record(tunise, got)
    try:
        summary = cli.serve(path, tunise, slots=2, lm_dtype=torch.float32)
    finally:
        del tunise._decode_tokens
    s1, s2 = tmp_path / "sep_s1.wav", tmp_path / "sep_s2.wav"
    assert summary["outputs"] == [str(tmp_path / "se_out.wav"), str(s1),
                                  str(s2)]
    assert summary["cascades"] == 1
    assert summary["segments"] == 1 + 1 + 2 * 2
    assert summary["engine_stats"]["requests_completed"] == 6
    for p in (s1, s2):
        out, fs = read_wav(p)
        assert fs == 16000 and out.shape == (1, 8000)
        assert np.isfinite(out).all()

    x = cli._prepare_wav(read_wav(tmp_path / "ss.wav")[0], 48000)
    assert x.shape == (1, 8000)
    want = []
    _record(unise, want)
    try:
        unise.separate_ss(x, jax.random.PRNGKey(0), do_sample=False)
    finally:
        del unise._decode_tokens
    _assert_same_tokens(got[1:], want[1:])  # got[0] is the SE line

    path.write_text(json.dumps({"task": "ss", "mix": str(tmp_path / "no.wav"),
                                "output": "o.wav"}))
    with pytest.raises(SystemExit):
        cli.main(["serve", "--requests", str(path), "--device", "cpu"])
