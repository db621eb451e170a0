"""``cli enhance`` of the port against the JAX package's ``cmd_enhance`` on
the tiny UniSE stack (both ``_build_unise`` replaced by it).

Greedy: the tokens each mode decodes must be identical and the wavs it
writes agree within 1e-4 (both are PCM16 files, so within a step of the
16-bit grid). A 48-kHz input is resampled after the build. The error
paths exit before a model is built, and without a card the command exits
unless ``--device cpu`` is given.
"""
import numpy as np
import pytest
import torch

from test_torch_common import TOL, port_unise, tiny_unise_jax
from unified_audio_tpu import cli as jcli
from unified_audio_tpu.utils.convert import export_custom_llama_state_dict
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav


@pytest.fixture(scope="module")
def stacks():
    unise = tiny_unise_jax()
    return unise, port_unise(unise)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(5)
    # 9600 samples: two 0.4-s segments of the tiny stack
    write_wav(d / "mix.wav", (0.3 * rng.standard_normal(9600)).astype(
        np.float32), 16000)
    write_wav(d / "enroll.wav", (0.3 * rng.standard_normal(5000)).astype(
        np.float32), 16000)
    return d


def _recording(obj, store):
    inner = obj._decode_tokens

    def wrapped(g, s, orig_len):
        store.append((np.asarray(g), np.asarray(s)))
        return inner(g, s, orig_len)

    obj._decode_tokens = wrapped
    return obj


def _outputs(path, mode):
    if mode != "ss":
        return [path]
    return [path.with_name(path.stem + s + ".wav") for s in ("_s1", "_s2")]


@pytest.mark.parametrize("mode", ["se", "tse", "ss"])
def test_enhance_matches_jax(stacks, wavs, tmp_path, monkeypatch, capsys,
                             mode):
    unise, tunise = stacks
    got, want = [], []
    monkeypatch.setattr(cli, "_build_unise",
                        lambda **kw: _recording(tunise, got))
    monkeypatch.setattr(jcli, "_build_unise",
                        lambda **kw: _recording(unise, want))
    argv = ["enhance", "--mode", mode, "--input", str(wavs / "mix.wav")]
    if mode == "tse":
        argv += ["--enroll", str(wavs / "enroll.wav")]
    cli.main(argv + ["--output", str(tmp_path / "port.wav"), "--device",
                     "cpu"])
    assert capsys.readouterr().out.strip() == "done (random weights)"
    jcli.main(argv + ["--output", str(tmp_path / "jax.wav")])
    assert len(got) == len(want) == (3 if mode == "ss" else 1)
    for (tg, ts), (jg, js) in zip(got, want):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(ts, js)
    for p, j in zip(_outputs(tmp_path / "port.wav", mode),
                    _outputs(tmp_path / "jax.wav", mode)):
        (pw, pfs), (jw, jfs) = read_wav(p), read_wav(j)
        assert pfs == jfs == 16000 and pw.shape == jw.shape == (1, 9600)
        np.testing.assert_allclose(pw, jw, **TOL)


def test_enhance_resamples_a_48k_input_after_the_build(stacks, tmp_path,
                                                      monkeypatch):
    """A 48-kHz input (and enrollment) is resampled to 16 kHz only after
    the model build, which turns TF32 off for the resampling conv on the
    card; the tokens equal JAX's and the output is 16 kHz."""
    unise, tunise = stacks
    rng = np.random.default_rng(6)
    for name, n in (("mix48.wav", 28800), ("enroll48.wav", 15000)):
        write_wav(tmp_path / name, (0.3 * rng.standard_normal(n)).astype(
            np.float32), 48000)
    events, got, want = [], [], []
    prepare = cli._prepare_wav

    def build(**kw):
        events.append("build")
        return _recording(tunise, got)

    def recorded_prepare(wav, fs, *a, **kw):
        events.append(("prepare", fs))
        return prepare(wav, fs, *a, **kw)

    monkeypatch.setattr(cli, "_build_unise", build)
    monkeypatch.setattr(cli, "_prepare_wav", recorded_prepare)
    monkeypatch.setattr(jcli, "_build_unise",
                        lambda **kw: _recording(unise, want))
    argv = ["enhance", "--mode", "tse", "--input", str(tmp_path / "mix48.wav"),
            "--enroll", str(tmp_path / "enroll48.wav")]
    cli.main(argv + ["--output", str(tmp_path / "port.wav"), "--device",
                     "cpu"])
    assert events == ["build", ("prepare", 48000), ("prepare", 48000)]
    jcli.main(argv + ["--output", str(tmp_path / "jax.wav")])
    for (tg, ts), (jg, js) in zip(got, want, strict=True):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(ts, js)
    (pw, pfs), (jw, jfs) = (read_wav(tmp_path / "port.wav"),
                            read_wav(tmp_path / "jax.wav"))
    assert pfs == jfs == 16000 and pw.shape == jw.shape == (1, 9600)
    np.testing.assert_allclose(pw, jw, **TOL)


def test_enhance_with_a_reference_checkpoint(stacks, wavs, tmp_path,
                                             monkeypatch, capsys):
    """``--ckpt`` with the reference's "dnn." prefix and conformer keys:
    the LM it loads decodes the JAX LM's greedy tokens."""
    unise, tunise = stacks
    cfg = unise.config.llm
    sd = {f"dnn.{k}": torch.as_tensor(np.ascontiguousarray(v))
          for k, v in export_custom_llama_state_dict(
              {"params": unise.sft_params["params"]}, cfg).items()}
    sd["dnn.conformer.embed.weight"] = torch.zeros(4, 3)
    torch.save(sd, tmp_path / "lm.pt")
    fresh = port_unise(unise)
    torch.nn.init.zeros_(fresh.sft.output_head.weight)  # the load restores it

    def build(ckpt=None, device="cpu", **kw):
        cli.load_lm(fresh.sft, ckpt, device)
        return fresh

    got, want = [], []
    monkeypatch.setattr(cli, "_build_unise",
                        lambda **kw: _recording(build(**kw), got))
    monkeypatch.setattr(jcli, "_build_unise",
                        lambda **kw: _recording(unise, want))
    argv = ["enhance", "--input", str(wavs / "mix.wav")]
    cli.main(argv + ["--output", str(tmp_path / "p.wav"), "--ckpt",
                     str(tmp_path / "lm.pt"), "--device", "cpu"])
    out = capsys.readouterr()
    assert out.out.strip() == "done" and "conformer.* (1)" in out.err
    jcli.main(argv + ["--output", str(tmp_path / "j.wav")])
    for (tg, ts), (jg, js) in zip(got, want):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("case", ["missing input", "tse without enroll",
                                  "missing enroll", "missing ckpt",
                                  "no card"])
def test_enhance_fails_fast(wavs, tmp_path, monkeypatch, case):
    built = []
    monkeypatch.setattr(cli, "_build_unise", lambda **kw: built.append(kw))
    argv = ["enhance", "--input", str(wavs / "mix.wav"), "--output",
            str(tmp_path / "o.wav"), "--device", "cpu"]
    if case == "missing input":
        argv[2] = str(tmp_path / "nope.wav")
    elif case == "tse without enroll":
        argv += ["--mode", "tse"]
    elif case == "missing enroll":
        argv += ["--mode", "tse", "--enroll", str(tmp_path / "nope.wav")]
    elif case == "missing ckpt":
        argv += ["--ckpt", str(tmp_path / "nope.pt")]
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = argv[:-2]
    with pytest.raises(SystemExit) as exit_info:
        cli.main(argv)
    assert exit_info.value.code not in (0, None)
    if case == "no card":
        assert "--device cpu" in str(exit_info.value.code)
    assert not built
