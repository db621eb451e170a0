"""Port vs JAX: UniSE's SFT training on a tiny stack (the tokenizing BiCodec
over a 17-layer XLSR-shaped SSL, a 2-layer WavLM, a 2-layer LM).

* ``LLMSFT``'s loss and accuracy for se, tse and rtse within 1e-5, and
  every LM gradient, mapped through ``llmsft_state_dict``, within 1e-4 of
  ``jax.grad`` (max |diff| over max |grad|, per tensor);
* the learning-rate schedule, the global-norm clip and the rates the
  optimizer runs at, against optax;
* three ``SFTTrainer`` steps (warmup 2): losses within 1e-5 and the LM's
  parameters within 1e-5 of the JAX ``SFTTrainer``'s; ``Validator.run``
  within 1e-5;
* a run saved, restored and resumed equals one uninterrupted, the
  optimizer's moments and the schedule included;
* ``cli train-unise --device cpu`` writes metrics and checkpoints, resumes
  from them, and ``cli serve --ckpt`` on its checkpoint gives the greedy
  tokens of the model in memory; without a card and without ``--device
  cpu`` it exits with an error.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_common import port_unise, tiny_train_unise_jax
from unified_audio_tpu.models.unise.model import TASK_MAP
from unified_audio_tpu.train import optim as j_optim
from unified_audio_tpu.train.sft_trainer import SFTTrainer as JSFTTrainer
from unified_audio_tpu.train.sft_trainer import Validator as JValidator
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.train import optim as t_optim
from unified_audio_tpu_torch.train.checkpoint import CheckpointManager
from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer, Validator
from unified_audio_tpu_torch.utils import convert as t_convert

SEG = 6400  # the tiny stack's 0.4-s segment


@pytest.fixture(scope="module")
def stacks():
    unise = tiny_train_unise_jax()
    return unise, port_unise(unise)


def _batch(task, seed, b=2):
    rng = np.random.default_rng(seed)

    def w():
        return (0.3 * rng.standard_normal((b, SEG))).astype(np.float32)

    enroll = w() if task != "se" else None
    return task, enroll, w(), w()


def _assert_lm_close(port_sd, jax_params, cfg, rtol):
    want = t_convert.llmsft_state_dict(jax.device_get(jax_params), cfg)
    assert set(want) == set(port_sd)
    for k, w in want.items():
        # a parameter the task does not reach (SE's enroll SOS) has no
        # gradient in torch and a zero one in JAX
        g = (np.zeros_like(w) if port_sd[k] is None
             else port_sd[k].detach().numpy())
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= rtol, f"{k}: {err:.3e}"


@pytest.fixture(scope="module")
def frozen(stacks):
    """The JAX side's frozen inputs of one batch: (enroll feats, mix
    feats, global ids, semantic ids) as numpy."""
    unise, _ = stacks
    _, enroll, mix, target = _batch("tse", 2)
    g, s = unise.tokenizer.tokenize(jnp.asarray(target))
    return tuple(np.asarray(x) for x in (
        unise.extract_semantic_features(jnp.asarray(enroll)),
        unise.extract_semantic_features(jnp.asarray(mix)), g[:, 0, :], s))


@pytest.mark.parametrize("task", ["se", "tse", "rtse"])
def test_sft_loss_acc_and_grads(stacks, frozen, task):
    """``LLMSFT`` on the same frozen inputs: the loss and accuracy within
    1e-5, every gradient within 1e-4 of its largest entry."""
    unise, tunise = stacks
    enroll, mix, g, s = frozen
    if task == "se":
        enroll = None
    task_id = jnp.int32(TASK_MAP[task])

    def loss(p, e):
        return unise.sft.apply(p, task_id, e, mix, g, s)

    (jl, ja), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        unise.sft_params, enroll)
    sft = tunise.sft.train()
    sft.zero_grad()
    tl, ta = sft(TASK_MAP[task], *[None if x is None else torch.tensor(x)
                                   for x in (enroll, mix, g, s)])
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, atol=0)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-5, atol=1e-7)
    grads = {k: p.grad for k, p in sft.named_parameters()}
    _assert_lm_close(grads, jgrad, unise.config.llm, 1e-4)
    sft.zero_grad()


def test_unreached_parameter_updates_like_optax():
    """A parameter the loss does not reach (SE's enrollment SOS) has no
    torch gradient; optax sees a zero one, so its Adam moments decay and
    the weight decay applies. Two updates, the second without a
    gradient, equal optax's."""
    w0 = np.array([0.5, -1.5, 2.0], np.float32)
    p = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    opt = t_optim.Optimizer([p], warmup_steps=1)
    tx = j_optim.make_optimizer(warmup_steps=1)
    jp = jnp.asarray(w0)
    state = tx.init(jp)
    for grad in (np.array([0.3, -0.2, 0.1], np.float32), None):
        p.grad = None if grad is None else torch.as_tensor(grad)
        opt.step()
        upd, state = tx.update(jnp.zeros(3) if grad is None else
                               jnp.asarray(grad), state, jp)
        jp = jp + upd
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-8)
    assert not np.allclose(np.asarray(jp), w0)


def test_loss_closed_form_at_full_vocab():
    """The closed-form KL equals the JAX package's one-hot form at the
    full 12,291-entry vocabulary, within 1e-5 relative."""
    from unified_audio_tpu.models.lm.llama import CodecLM, LlamaConfig
    from unified_audio_tpu_torch.models.lm import llama as t_llama

    cfg = LlamaConfig()
    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((3, 50, cfg.vocab_size))).astype(
        np.float32)
    targets = rng.integers(0, cfg.vocab_size, (3, 50)).astype(np.int32)
    want = CodecLM(cfg).apply({}, jnp.asarray(logits), jnp.asarray(targets),
                              method="loss_function")
    got = t_llama.CodecLM.loss_function(
        type("M", (), {"cfg": t_llama.LlamaConfig()})(),
        torch.as_tensor(logits), torch.as_tensor(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("step", [0, 1, 2000, 2001, 100_000])
def test_schedule(step):
    want = float(j_optim.warmup_exp_decay_schedule()(step))
    got = t_optim.warmup_exp_decay_schedule()(step)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_optimizer_rates_follow_the_schedule():
    """Update t runs at schedule(t), from schedule(0) = 0, as optax
    counts."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = t_optim.Optimizer([p], warmup_steps=3)
    sched = t_optim.warmup_exp_decay_schedule(warmup_steps=3)
    for t in range(6):
        assert opt.lr == sched(t)
        p.grad = torch.ones(3)
        opt.step()
    assert sched(0) == 0.0


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(10)
    grads = [(scale * rng.standard_normal(s)).astype(np.float32)
             for s in ((4, 5), (7,), (3, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.as_tensor(g.copy()) for g in grads]
    t_optim.clip_by_global_norm_(got, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_trainer_three_steps_and_validator(stacks):
    """Three TSE steps (warmup 2) of both trainers on the same batches
    (the first at rate 0, as optax counts); then both validators on two
    batches."""
    unise, _ = stacks
    tunise = port_unise(unise)  # its own LM: the trainer updates it
    jt = JSFTTrainer(unise, optimizer=j_optim.make_optimizer(warmup_steps=2))
    tt = SFTTrainer(tunise, t_optim.Optimizer(tunise.sft.parameters(),
                                              warmup_steps=2))
    for i, task in enumerate(["tse"] * 3):
        batch = _batch(task, 20 + i)
        jl, ja = jt.train_step(*batch)
        tl, ta = tt.train_step(*batch)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-7)
    want = t_convert.llmsft_state_dict(jax.device_get(jt.params),
                                       unise.config.llm)
    for k, p in tunise.sft.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    batches = [(task, e, m, s, s[::-1].copy(), None, None, None)
               for task, e, m, s in (_batch("tse", 30), _batch("tse", 31))]
    jv = JValidator(unise).run(jt.params, batches)
    tv = Validator(tunise).run(batches)
    assert tv["num_batches"] == jv["num_batches"] == 2
    for k in ("valid_loss", "valid_acc"):
        np.testing.assert_allclose(tv[k], jv[k], rtol=1e-5, atol=1e-7)


def _trainer(unise, state=None):
    tunise = port_unise(unise)
    t = SFTTrainer(tunise, t_optim.Optimizer(tunise.sft.parameters(),
                                             warmup_steps=2))
    if state is not None:
        t.load_state_dict(state)
    return t


def test_resume_equals_uninterrupted(stacks, tmp_path):
    """Two steps, a checkpoint, a new trainer restored from it, two more
    steps: the LM, the Adam moments and the next rate equal four steps of
    one trainer (the JAX CLI's resume restarts the warmup and the
    moments)."""
    unise, _ = stacks
    batches = [_batch("tse", 40 + i) for i in range(4)]
    whole = _trainer(unise)
    for b in batches:
        whole.train_step(*b)
    first = _trainer(unise)
    for b in batches[:2]:
        first.train_step(*b)
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    for step in (1, 2):
        mgr.save(step, first.state_dict())
    mgr.save(0, first.state_dict())  # the oldest of 3 goes: 0
    assert mgr.steps() == [1, 2] and mgr.latest_step() == 2
    resumed = _trainer(unise, mgr.restore())
    assert resumed.step == 2 and resumed.optimizer.lr == first.optimizer.lr
    assert resumed.optimizer.lr > 0
    for b in batches[2:]:
        resumed.train_step(*b)
    for (k, a), b in zip(whole.sft.state_dict().items(),
                         resumed.sft.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    sw, sr = (t.optimizer.adamw.state_dict()["state"]
              for t in (whole, resumed))
    for i in sw:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sr[i][name], sw[i][name], rtol=0,
                                       atol=0)
    assert resumed.optimizer.lr == whole.optimizer.lr


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _write_scps(tmp_path):
    """3 speakers x 2 utterances of 0.5 s, a noise, an RIR."""
    rng = np.random.default_rng(50)
    lines = []
    for spk in range(3):
        for u in range(2):
            path = tmp_path / f"s{spk}_{u}.wav"
            write_wav(path, (0.3 * np.sin(np.arange(8000) * (0.02 + 0.01 *
                                                             spk))
                             + 0.05 * rng.standard_normal(8000)).astype(
                np.float32), 16000)
            lines.append(f"u{spk}_{u} spk{spk} {path}")
    (tmp_path / "speech.scp").write_text("\n".join(lines) + "\n")
    write_wav(tmp_path / "noise.wav",
              (0.1 * rng.standard_normal(12000)).astype(np.float32), 16000)
    (tmp_path / "noise.scp").write_text(
        f"n0 16000 0 12000 {tmp_path / 'noise.wav'}\n")
    rir = np.zeros(800, np.float32)
    rir[[0, 100, 400]] = [1.0, 0.4, 0.1]
    write_wav(tmp_path / "rir.wav", rir, 16000)
    (tmp_path / "rir.scp").write_text(f"r0 {tmp_path / 'rir.wav'}\n")


def _config(tmp_path, steps):
    data = {"speech_scp": [str(tmp_path / "speech.scp")],
            "noise_scp": [str(tmp_path / "noise.scp")],
            "rir_scp": [str(tmp_path / "rir.scp")], "batch_size": 2,
            "cut_duration": [0.4, 0.4], "enroll_duration": 0.4,
            "num_workers": 1, "prefetch": 2,
            "samples_per_epoch": 2 * steps}
    cfg = {"seed": 3407, "ckpt_dir": str(tmp_path / "ckpt"),
           "max_epochs": 1, "log_every": 1, "save_every": 3,
           "opt": {"peak_lr": 5e-4, "warmup_steps": 2},
           "dataset": data, "val_dataset": dict(data, seed=7),
           "val_every": 2, "val_batches": 1}
    path = tmp_path / f"train{steps}.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return path


def test_cli_train_unise_cpu(stacks, tmp_path, monkeypatch, capsys):
    unise, _ = stacks
    built = []

    def build(ckpt=None, device="cpu", **kw):
        tunise = port_unise(unise)
        if ckpt:
            cli.load_lm(tunise.sft, ckpt, device)
        built.append(tunise)
        return tunise

    monkeypatch.setattr(cli, "_build_unise", build)
    _write_scps(tmp_path)
    trainer = cli.main(["train-unise", "--config",
                        str(_config(tmp_path, 3)), "--device", "cpu"])
    assert trainer.step == 3
    recs = [json.loads(l) for l in
            (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in train)
    sched = t_optim.warmup_exp_decay_schedule(warmup_steps=2)
    assert [r["lr"] for r in train] == [sched(0), sched(1), sched(2)]
    assert train[0]["lr"] == 0.0
    assert [r["step"] for r in recs if "valid_loss" in r] == [2]
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.steps() == [2, 3]

    # a second run resumes at step 3 with the schedule and moments
    capsys.readouterr()
    again = cli.main(["train-unise", "--config", str(_config(tmp_path, 2)),
                      "--device", "cpu"])
    assert "resumed from step 3" in capsys.readouterr().err
    assert again.step == 5
    recs = [json.loads(l) for l in
            (tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r][-2:] == [4, 5]
    assert [r["lr"] for r in recs if "loss" in r][-2] == sched(3)

    # cli serve on the step-3 checkpoint = the model as it was at step 3
    for name, seed in (("mix", 60), ("enroll", 61)):
        write_wav(tmp_path / f"{name}.wav", (0.2 * np.random.default_rng(
            seed).standard_normal(7000)).astype(np.float32), 16000)
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text(json.dumps(
        {"task": "tse", "mix": str(tmp_path / "mix.wav"),
         "enroll": str(tmp_path / "enroll.wav"),
         "output": str(tmp_path / "out.wav"), "do_sample": False}))
    got, want = [], []
    monkeypatch.setattr(cli, "_build_unise", lambda ckpt=None, device="cpu",
                        **kw: _recording(build(ckpt, device), got))
    cli.main(["serve", "--requests", str(reqs), "--slots", "2", "--device",
              "cpu", "--ckpt", str(mgr.path(3))])
    cli.serve(reqs, _recording(trainer.unise, want), slots=2)
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)


def _recording(tunise, store):
    """Record the tokens ``tunise`` decodes."""
    inner = tunise._decode_tokens

    def wrapped(g, s, orig_len):
        store.append((np.asarray(g), np.asarray(s)))
        return inner(g, s, orig_len)

    tunise._decode_tokens = wrapped
    return tunise


def test_train_unise_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(cli, "_build_unise", lambda **kw: built.append(kw))
    path = tmp_path / "c.yaml"
    path.write_text("{}")
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["train-unise", "--config", str(path)])
    assert "--device cpu" in str(exit_info.value.code)
    assert not built
