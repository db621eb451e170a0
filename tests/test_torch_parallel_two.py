"""The port's parallel training on 2 gloo ranks
(``tests/torch_parallel_worker.py``) against the JAX package's dense
results and the port's own single-device run:

* UniSE's SFT step at pp = 2 (2 microbatches) and at tp = 2: loss and
  accuracy within 1e-5 relative of JAX's dense step, every LM gradient
  within 1e-4 of its largest entry, before the global-norm clip and after
  it (at ``CLIP``, far below the norm, so the clip scales every gradient
  by the norm of the whole model, its shards' squares summed over tp or
  pp);
* the data at dp1 x tp2: with 4 loader threads the two tp peers train on
  the same batches (``share_batches``);
* checkpoints: the tp = 2 and pp = 2 runs' files (gathered, written by
  rank 0) resume at world size 1, weights equal and Adam moments within
  2e-4 of their largest entry to the single-device trainer's after the
  same step, and the next step's loss within 1e-5; a single-device
  checkpoint loaded at tp = 2 and gathered again comes back bit-equal;
* the paged decode step at tp = 2: logits within 2e-4, the pool within
  2e-5 (JAX's bounds).
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import port_unise, tiny_train_unise_jax
from test_torch_parallel import (assert_peers_share_batches,
                                 assert_sft_matches, jax_sft_step, of,
                                 rel_close, sft_batch, spawn,
                                 unise_arrays_and_cfgs, write_scps)
from test_torch_parallel_layers import paged_case
from unified_audio_tpu_torch.train import optim as t_optim
from unified_audio_tpu_torch.train.checkpoint import CheckpointManager
from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer
from unified_audio_tpu_torch.utils import convert as t_convert

CLIP = 1e-3  # the steps' global-norm clip: the tiny LM's norm is far above


@pytest.fixture(scope="module")
def unise_pair():
    unise = tiny_train_unise_jax()
    return unise, port_unise(unise)


def dense_trainer(unise, state=None):
    tunise = port_unise(unise)
    t = SFTTrainer(tunise, t_optim.Optimizer(tunise.sft.parameters(),
                                             warmup_steps=2, grad_clip=CLIP))
    if state is not None:
        t.load_state_dict(state)
    return t


@pytest.fixture(scope="module")
def world2(unise_pair, tmp_path_factory):
    unise, tunise = unise_pair
    arrays, cfgs = unise_arrays_and_cfgs(tunise)
    sbatch = sft_batch()
    arrays.update({f"batch.{k}": v for k, v in sbatch.items()})
    job = tmp_path_factory.mktemp("two") / "job"
    job.mkdir()
    # the single-device run's checkpoint after one step, for tp = 2 to load
    dense = dense_trainer(unise)
    dense.train_step("tse", sbatch["enroll"], sbatch["mix"],
                     sbatch["target"])
    torch.save(dense.state_dict(), job / "dense.pt")

    kcfg, variables, pool, inputs, _ = paged_case()
    arrays.update({f"paged.lm.{k}": np.asarray(v) for k, v in
                   t_convert.llmsft_state_dict(variables, kcfg).items()})
    arrays.update({f"paged.{k}": v for k, v in {**pool, **inputs}.items()})

    sft = dict(kind="sft", cfgs=cfgs, task="tse", warmup=2, grad_clip=CLIP)
    scenarios = [
        dict(sft, name="pp2", mesh={"pp": 2}, microbatches=2,
             save="pp2_ckpt"),
        dict(sft, name="tp2", mesh={"dp": 1, "tp": 2}, save="tp2_ckpt",
             load="dense.pt"),
        dict(kind="paged", name="paged", mesh={"dp": 1, "tp": 2},
             cfg=dataclasses.asdict(kcfg), feats_dim=12),
        dict(kind="data", name="data", mesh={"dp": 1, "tp": 2},
             dataset=write_scps(job), batches=3),
    ]
    return spawn(job, 2, scenarios, arrays), job, dense, sbatch


@pytest.fixture(scope="module")
def jax_step(unise_pair):
    unise, _ = unise_pair
    return jax_sft_step(unise, sft_batch())


@pytest.mark.parametrize("name", ["pp2", "tp2"])
def test_sft_step_matches_jax_dense(world2, jax_step, name):
    results = world2[0]
    for r in results:
        assert_sft_matches(of(r, name), *jax_step)


@pytest.mark.parametrize("name", ["pp2", "tp2"])
def test_sharded_clip_matches_dense(world2, jax_step, name):
    """The global-norm clip at pp = 2 and tp = 2 scales every gradient, the
    shards' and the replicated ones', by ``CLIP`` over the norm of the
    whole model's gradient: the clipped gradients equal JAX's dense ones
    so scaled within 1e-4 of the largest entry. A norm summed over the
    wrong group, or over this rank's shards alone, scales them by another
    factor."""
    _, _, grads = jax_step
    norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                       for g in grads.values()))
    assert norm > 100 * CLIP, norm
    want = {k: np.asarray(g, np.float64) * (CLIP / norm)
            for k, g in grads.items()}
    for r in world2[0]:
        res = of(r, name)
        rel_close({k[len("clipped/"):]: v for k, v in res.items()
                   if k.startswith("clipped/")}, want, 1e-4,
                  "clipped gradients")


def test_data_tp_peers_share_batches(world2):
    """At dp1 x tp2, with 4 loader threads a rank and random crop lengths,
    both tp peers train on the batches of the first (shard (0, 1))."""
    data = [of(r, "data") for r in world2[0]]
    assert [tuple(d["shard"]) for d in data] == [(0, 1), (0, 1)]
    assert_peers_share_batches(data, ((0, 1),))


@pytest.mark.parametrize("name", ["pp2", "tp2"])
def test_checkpoint_resumes_at_world_one(world2, unise_pair, name):
    """The file rank 0 wrote holds the whole LM and Adam's moments in the
    single-device layout: a world-1 trainer loads it, equals the
    single-device trainer after the same step, and its next step's loss
    matches."""
    _, job, dense, sbatch = world2
    unise, _ = unise_pair
    blob = CheckpointManager(job / f"{name}_ckpt").restore()
    assert blob["step"] == 1
    resumed = dense_trainer(unise, blob)
    want = dense.state_dict()
    for k, v in want["state_dict"].items():
        np.testing.assert_array_equal(resumed.sft.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    got_state = resumed.optimizer.adamw.state_dict()["state"]
    want_state = want["optimizer"]["adamw"]["state"]
    assert set(got_state) == set(want_state)
    for i, s in want_state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            w = s[key].numpy()
            err = np.abs(got_state[i][key].numpy() - w).max()
            assert err <= 2e-4 * max(np.abs(w).max(), 1e-30), (i, key, err)
    assert resumed.optimizer.lr == dense.optimizer.lr
    nxt = sft_batch(seed=8)
    a = resumed.train_step("tse", nxt["enroll"], nxt["mix"], nxt["target"])
    # a deep copy: a loaded optimizer shares the state's tensors
    b = dense_trainer(unise, copy.deepcopy(dense.state_dict())).train_step(
        "tse", nxt["enroll"], nxt["mix"], nxt["target"])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=0)


def test_world_one_checkpoint_loads_at_tp2(world2):
    """A single-device checkpoint loaded at tp = 2 (cut to each rank's
    shards) and gathered again is the same file, bit for bit."""
    results, job, _, _ = world2
    want = torch.load(job / "dense.pt", weights_only=True)
    for r in results:
        res = of(r, "tp2")
        assert int(res["loaded_step"]) == want["step"]
        for k, v in want["state_dict"].items():
            np.testing.assert_array_equal(res[f"loaded/{k}"], v.numpy(),
                                          err_msg=k)
        for i, s in want["optimizer"]["adamw"]["state"].items():
            np.testing.assert_array_equal(res[f"loaded_m/{i}"],
                                          s["exp_avg"].numpy())
            np.testing.assert_array_equal(res[f"loaded_v/{i}"],
                                          s["exp_avg_sq"].numpy())


@pytest.mark.parametrize("mode", ["plain", "owner"])
def test_paged_decode_tp2_matches_unsharded(world2, mode):
    from unified_audio_tpu.serve.paged import paged_decode_ids

    cfg, variables, pool, inputs, bs = paged_case()
    logits, new_pool = paged_decode_ids(
        cfg, variables["params"]["lm"], {k: jnp.asarray(v)
                                         for k, v in pool.items()},
        *(jnp.asarray(inputs[k]) for k in ("tables", "index", "active",
                                           "ids")), bs)
    for r in world2[0]:
        res = of(r, "paged")
        assert int(res[f"{mode}/heads"]) == 2
        np.testing.assert_allclose(res[f"{mode}/logits"],
                                   np.asarray(logits), atol=2e-4, rtol=0)
        for k in ("k", "v"):
            np.testing.assert_allclose(res[f"{mode}/{k}"],
                                       np.asarray(new_pool[k]), atol=2e-5,
                                       rtol=0)


# ---------------------------------------------------------------------------
# cli train-unise under torchrun
# ---------------------------------------------------------------------------

def _torchrun_env(monkeypatch, world, rank, local_rank):
    """torchrun's environment for one process."""
    from test_torch_parallel import free_port

    for k, v in dict(WORLD_SIZE=world, RANK=rank, LOCAL_RANK=local_rank,
                     LOCAL_WORLD_SIZE=world, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=free_port()).items():
        monkeypatch.setenv(k, str(v))


def test_cli_train_unise_under_torchrun_cpu(unise_pair, tmp_path,
                                            monkeypatch, capsys):
    """``train-unise --device cpu`` in torchrun's environment (world 1):
    it joins a gloo group on the (dp 1, tp 1) mesh, rank 0 logs and writes
    the checkpoint, the group is gone afterwards, and the losses equal the
    same run's without torchrun within 1e-6 relative."""
    import json

    from test_torch_train import _config, _write_scps
    from unified_audio_tpu_torch import cli

    unise, _ = unise_pair
    monkeypatch.setattr(cli, "_build_unise",
                        lambda ckpt=None, device="cpu", **kw: port_unise(
                            unise))
    losses = {}
    for name in ("single", "torchrun"):
        run = tmp_path / name
        run.mkdir()
        _write_scps(run)
        with monkeypatch.context() as mp:
            if name == "torchrun":
                _torchrun_env(mp, 1, 0, 0)
            capsys.readouterr()
            trainer = cli.main(["train-unise", "--config",
                                str(_config(run, 3)), "--device", "cpu"])
            err = capsys.readouterr().err
        assert trainer.step == 3
        assert ("torchrun: gloo group of 1 on the (dp 1, tp 1) mesh" in err) \
            == (name == "torchrun")
        assert not torch.distributed.is_initialized()
        recs = [json.loads(line) for line in (run / "ckpt" / "metrics.jsonl")
                .read_text().splitlines()]
        losses[name] = [r["loss"] for r in recs if "loss" in r]
        assert CheckpointManager(run / "ckpt").steps() == [2, 3]
    np.testing.assert_allclose(losses["torchrun"], losses["single"],
                               rtol=1e-6, atol=0)


def test_cli_train_unise_local_rank_beyond_cards(tmp_path, monkeypatch):
    """A LOCAL_RANK past the visible cards ends the command with an error
    before any group or model is made."""
    from test_torch_train import _config, _write_scps
    from unified_audio_tpu_torch import cli

    _write_scps(tmp_path)
    _torchrun_env(monkeypatch, 2, 0, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cli, "_build_unise", lambda **kw: pytest.fail(
        "the model was built"))
    with pytest.raises(SystemExit, match="local rank 3 has no card: 1"):
        cli.main(["train-unise", "--config", str(_config(tmp_path, 1))])
    assert not torch.distributed.is_initialized()
