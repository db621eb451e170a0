"""``orbax_to_torch.py`` (the root script that brings the JAX package's
orbax LM checkpoints into the port) and the port's refusal of a checkpoint
directory, on the CPU.

A tiny LM's variables (what JAX's ``SFTTrainer.params`` holds and ``cli
train-unise`` saves) go into a JAX ``CheckpointManager`` at steps 3 and 7.
The script converts them, as a function and as a subprocess with
``--step``; the port's LM loaded from the file through ``cli.load_lm``
generates greedy tokens exactly equal to JAX's LM restored by JAX's own
``_load_sft_checkpoint`` (the latest step) or by its manager (step 3).
A directory passed to the port's ``--ckpt`` ends the command with an error
that names the script and its command line, before any model is built.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbax_to_torch
from test_torch_common import REPO, jax_sft, port_config, tiny_lm_config
from unified_audio_tpu.cli import _load_sft_checkpoint
from unified_audio_tpu.train.checkpoint import CheckpointManager
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.models.lm.sft import LLMSFT as TLLMSFT
from unified_audio_tpu_torch.utils import convert as t_convert


@pytest.fixture(scope="module")
def orbax_dir(tmp_path_factory):
    cfg = tiny_lm_config()
    sft, v3 = jax_sft(cfg, seed=3)
    _, v7 = jax_sft(cfg, seed=7)
    d = tmp_path_factory.mktemp("orbax") / "ckpt"
    mgr = CheckpointManager(d)
    mgr.save(3, v3)
    mgr.save(7, v7)
    return cfg, sft, d


def _greedy(cfg, sft, variables, tsft):
    rng = np.random.default_rng(11)
    mix = rng.standard_normal((2, 10, 12)).astype(np.float32)
    enr = rng.standard_normal((2, 6, 12)).astype(np.float32)
    jg, js = sft.apply(variables, 1, jnp.asarray(enr), jnp.asarray(mix),
                       jax.random.PRNGKey(0), method="generate",
                       global_length=4, semantic_length=7, do_sample=False)
    with torch.no_grad():
        tg, ts = tsft.generate(1, torch.as_tensor(enr), torch.as_tensor(mix),
                               None, global_length=4, semantic_length=7,
                               do_sample=False)
    return (np.asarray(jg), np.asarray(js)), (tg.numpy(), ts.numpy())


def _port_lm(cfg, path):
    tsft = TLLMSFT(port_config(cfg), num_tasks=3, feats_dim=12)
    cli.load_lm(tsft, path)
    return tsft.eval()


def test_latest_step_greedy_tokens_equal_jax(orbax_dir, tmp_path):
    cfg, sft, d = orbax_dir
    step, n = orbax_to_torch.convert(d, tmp_path / "lm.pt")
    assert step == 7
    tsft = _port_lm(cfg, tmp_path / "lm.pt")
    assert n == len(tsft.state_dict())
    want, got = _greedy(cfg, sft, _load_sft_checkpoint(str(d), cfg), tsft)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_step_option_as_a_subprocess(orbax_dir, tmp_path):
    """``python orbax_to_torch.py DIR OUT --step 3``: step 3's weights,
    not the latest's, and tokens equal to JAX's LM at step 3."""
    cfg, sft, d = orbax_dir
    out = tmp_path / "lm3.pt"
    proc = subprocess.run(
        [sys.executable, "orbax_to_torch.py", str(d), str(out), "--step",
         "3"], cwd=REPO, capture_output=True, text=True, timeout=240,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert f"of step 3 to {out}" in proc.stdout
    v3 = CheckpointManager(d).restore(3)["params"]
    sd = torch.load(out, weights_only=True)["state_dict"]
    want_sd = t_convert.llmsft_state_dict(jax.device_get(v3), cfg)
    assert set(sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v))
    want, got = _greedy(cfg, sft, v3, _port_lm(cfg, out))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_missing_step_exits(orbax_dir, tmp_path):
    _, _, d = orbax_dir
    with pytest.raises(SystemExit, match="no step 5 inside"):
        orbax_to_torch.main([str(d), str(tmp_path / "x.pt"), "--step", "5"])
    with pytest.raises(SystemExit, match="no checkpoint directory"):
        orbax_to_torch.main([str(tmp_path / "none"), str(tmp_path / "x.pt")])


def test_port_refuses_a_checkpoint_directory(orbax_dir, tmp_path,
                                             monkeypatch):
    """``cli.load_lm`` and ``cli enhance --ckpt DIR`` exit with the
    converter's command line instead of failing inside ``torch.load``; the
    command stops before building the model."""
    cfg, _, d = orbax_dir
    want = f"python orbax_to_torch.py {d} lm.pt"
    tsft = TLLMSFT(port_config(cfg), num_tasks=3, feats_dim=12)
    with pytest.raises(SystemExit, match="orbax_to_torch.py") as e:
        cli.load_lm(tsft, d)
    assert want in str(e.value)
    wav = tmp_path / "in.wav"
    cli.write_wav(wav, np.zeros(1600, np.float32), 16000)
    monkeypatch.setattr(cli, "_build_unise", lambda *a, **kw: pytest.fail(
        "the model was built"))
    for argv in (["enhance", "--mode", "se", "--input", str(wav),
                  "--output", str(tmp_path / "o.wav")],
                 ["eval", "--test-dir", str(tmp_path)]):
        with pytest.raises(SystemExit, match="orbax_to_torch.py") as e:
            cli.main(argv + ["--ckpt", str(d), "--device", "cpu"])
        assert want in str(e.value)
