"""``evaluate`` and ``cli eval`` of the port against the JAX package's on
the CPU, on the tiny UniSE stack (the tokenizing BiCodec, so SPK-SIM
runs): greedy tokens give the same enhanced waves, and the summaries agree
within 1e-4.
"""
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_common import port_unise, tiny_train_unise_jax
from test_torch_eval import (FS, _assert_summaries_close, _port_utmos,
                             _speechlike, _utmos)
from unified_audio_tpu import cli as jcli
from unified_audio_tpu.eval import metrics as jm
from unified_audio_tpu.eval import runner as jrunner
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.eval import metrics as tm
from unified_audio_tpu_torch.eval import runner as trunner


@pytest.fixture(scope="module")
def stacks():
    unise = tiny_train_unise_jax()
    return unise, port_unise(unise)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Three noisy/clean/enrollment triples of different lengths."""
    root = tmp_path_factory.mktemp("evalset")
    rng = np.random.default_rng(7)
    for d in ("noisy", "clean", "enroll"):
        (root / d).mkdir()
    for i, n in enumerate((9000, 6400, 12000)):
        clean = 0.5 * _speechlike(n, seed=i)
        noisy = clean + 0.1 * rng.standard_normal(n).astype(np.float32)
        write_wav(root / "noisy" / f"u{i}.wav", noisy, FS)
        write_wav(root / "clean" / f"u{i}.wav", clean, FS)
        write_wav(root / "enroll" / f"u{i}.wav",
                  0.3 * _speechlike(5000, seed=10 + i), FS)
    return root


@pytest.mark.parametrize("mode", ["se", "tse"])
def test_evaluate_equals_jax(stacks, dirs, tmp_path, mode):
    """``evaluate`` over the directory, SPK-SIM through each side's BiCodec
    and (SE) learned UTMOS: the summary equals JAX's within 1e-4 and the
    enhanced wavs are written."""
    unise, tunise = stacks
    cfg = dict(mode=mode, data_src_dir=str(dirs / "noisy"),
               data_tgt_dir=str(dirs / "clean"),
               data_enroll_dir=str(dirs / "enroll") if mode == "tse"
               else None)
    extra_j, extra_t = {}, {}
    if mode == "se":
        pred, sd = _utmos()
        torch.save(sd, tmp_path / "utmos.pt")
        extra_j["utmos_predictor"] = pred
        extra_t["utmos_predictor"] = _port_utmos(tmp_path / "utmos.pt")
    got = trunner.evaluate(
        tunise, trunner.EvalConfig(**cfg, save_enhanced=str(tmp_path / "o")),
        seed=0, spk_embed_fn=tm.make_spk_embed_fn(tunise.tokenizer.model),
        **extra_t)
    want = jrunner.evaluate(
        unise, jrunner.EvalConfig(**cfg), jax.random.PRNGKey(0),
        spk_embed_fn=jm.make_spk_embed_fn(unise.tokenizer.model,
                                          unise.tokenizer.variables),
        **extra_j)
    assert got["num_utts"] == 3.0
    assert ("utmos_learned" in got) == (mode == "se")
    _assert_summaries_close(got, want)
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == [
        "u0.wav", "u1.wav", "u2.wav"]


def test_cli_eval_equals_jax(stacks, dirs, monkeypatch, capsys):
    """``main(["eval", ...])`` of both CLIs with ``--spk-sim``: the JSON
    lines agree; the warnings and notes are JAX's."""
    unise, tunise = stacks
    monkeypatch.setattr(cli, "_build_unise", lambda **kw: tunise)
    monkeypatch.setattr(jcli, "_build_unise", lambda **kw: unise)
    argv = ["eval", "--test-dir", str(dirs / "noisy"), "--tgt-dir",
            str(dirs / "clean"), "--spk-sim", "--max-items", "2"]
    got = cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == got
    assert "--spk-sim without --bicodec-ckpt" in out.err
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["num_utts"] == want["num_utts"] == 2.0
    _assert_summaries_close(got, want)
    cli.main(argv[:-3] + ["--max-items", "1", "--device", "cpu"])
    assert "note: SPK-SIM skipped" in capsys.readouterr().err


def test_cli_eval_builds_the_speaker_side_and_utmos(dirs, tmp_path,
                                                   monkeypatch, capsys):
    """``--spk-sim`` asks ``_build_unise`` for the speaker side (not
    XLSR-53), ``--utmos-ckpt`` loads the predictor; a UTMOS checkpoint
    without ``ssl_model.*`` keys warns that HuBERT stays random."""
    seen = []

    def build(**kw):
        seen.append(kw)
        raise SystemExit("built")

    monkeypatch.setattr(cli, "_build_unise", build)
    with pytest.raises(SystemExit):
        cli.main(["eval", "--test-dir", str(dirs / "noisy"), "--spk-sim",
                  "--device", "cpu"])
    assert seen[0]["speaker"] is True and "tokenize" not in seen[0]
    _, sd = _utmos()
    torch.save({k: v for k, v in sd.items()
                if not k.startswith("ssl_model.")}, tmp_path / "head.pt")
    _port_utmos(tmp_path / "head.pt")
    assert "no ssl_model.* weights" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["missing dir", "missing utmos", "no card"])
def test_cli_eval_fails_fast(dirs, tmp_path, monkeypatch, case):
    built = []
    monkeypatch.setattr(cli, "_build_unise", lambda **kw: built.append(kw))
    argv = ["eval", "--test-dir", str(dirs / "noisy"), "--device", "cpu"]
    if case == "missing dir":
        argv[2] = str(tmp_path / "nope")
    elif case == "missing utmos":
        argv += ["--utmos-ckpt", str(tmp_path / "nope.pt")]
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = argv[:-2]
    with pytest.raises(SystemExit) as exit_info:
        cli.main(argv)
    assert exit_info.value.code not in (0, None)
    assert not built
