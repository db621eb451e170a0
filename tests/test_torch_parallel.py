"""The port's parallel training (``unified_audio_tpu_torch/parallel``)
against the JAX package's dense results, on the CPU.

Distributed runs happen in ``tests/torch_parallel_worker.py`` (JAX-free),
one process a rank over a gloo group, spawned once a file for a world
size; weights, batches and results travel as ``.npz``. Each spawn has its
own ``communicate(timeout=)`` and each group its own timeout, so a hung
collective fails a test file instead of the whole run. The JAX side runs
here, dense, on the same weights (``utils/convert.py``) and batch.

This file: the world of 4 ranks running UniSE's SFT step on a dp2 x tp2
mesh and on a dp2 x pp2 mesh (loss and accuracy within 1e-5 relative of
JAX's dense step on the global batch, every LM gradient within 1e-4 of
its largest entry, as ``test_torch_train.py`` holds the single-device
step), the data iterators' shards on the mesh, ``make_hybrid_mesh``; and
in-process the errors and rules that need no group. Gradients are
compared before the optimizer: Adam's first update is about lr * sign(g),
so updated weights cannot show a gradient scaled by tp, pp or dp.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import port_unise, tiny_train_unise_jax
from unified_audio_tpu_torch.parallel import distributed as t_dist
from unified_audio_tpu_torch.parallel import mesh as t_mesh
from unified_audio_tpu_torch.utils import convert as t_convert

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
SEG = 6400  # the tiny UniSE's 0.4-s segment
SPAWN_TIMEOUT_S = 150  # one spawn: every scenario of its world size


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job_dir: Path, world: int, scenarios, arrays):
    """Run ``scenarios`` on ``world`` worker processes -> each rank's
    results (dicts of numpy arrays)."""
    job_dir.mkdir(parents=True, exist_ok=True)
    (job_dir / "job.json").write_text(json.dumps(
        {"scenarios": scenarios, "timeout_s": SPAWN_TIMEOUT_S - 30}))
    np.savez(job_dir / "inputs.npz", **arrays)
    (job_dir / "port").unlink(missing_ok=True)  # rank 0 publishes its own
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(job_dir), str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(WORKER.parents[1]))
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                out = p.communicate(timeout=SPAWN_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:  # keep what the rank said
                p.kill()
                out = (p.communicate()[0]
                       + f"\n[killed after {SPAWN_TIMEOUT_S} s]")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [dict(np.load(job_dir / f"out_rank{r}.npz")) for r in range(world)]


def of(result: dict, scenario: str) -> dict:
    """The entries of one scenario, without its prefix."""
    p = f"{scenario}/"
    return {k[len(p):]: v for k, v in result.items() if k.startswith(p)}


def rel_close(got: dict, want: dict, tol: float, what: str):
    """Each tensor of ``want`` within ``tol`` of its largest entry."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        w = np.asarray(w)
        err = np.abs(np.asarray(got[k]) - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (what, k, err)


# ---------------------------------------------------------------------------
# UniSE: the stacks, the batch, JAX's dense step
# ---------------------------------------------------------------------------

def unise_arrays_and_cfgs(tunise):
    arrays = {}
    for prefix, module in (("sft.", tunise.sft),
                           ("bicodec.", tunise.tokenizer.model),
                           ("xlsr.", tunise.tokenizer.ssl),
                           ("wavlm.", tunise.wavlm)):
        arrays.update({prefix + k: v.numpy()
                       for k, v in module.state_dict().items()})
    cfgs = {"unise": dataclasses.asdict(tunise.config),
            "bicodec": dataclasses.asdict(tunise.tokenizer.config),
            "xlsr": dataclasses.asdict(tunise.tokenizer.ssl.config),
            "wavlm": dataclasses.asdict(tunise.wavlm.config)}
    return arrays, cfgs


def sft_batch(b=4, seed=7):
    rng = np.random.default_rng(seed)
    return {k: (0.3 * rng.standard_normal((b, SEG))).astype(np.float32)
            for k in ("enroll", "mix", "target")}


def jax_sft_step(unise, batch, task="tse"):
    """JAX's dense loss, accuracy and LM gradients (port layout) on the
    global batch."""
    frozen = unise.frozen_variables()
    enroll = None if task == "se" else jnp.asarray(batch["enroll"])

    @jax.jit
    def step(params, frozen):
        def loss(p):
            return unise.loss_fn(p, task, enroll, jnp.asarray(batch["mix"]),
                                 jnp.asarray(batch["target"]), frozen=frozen)
        return jax.value_and_grad(loss, has_aux=True)(params)

    (loss, acc), grads = step(unise.sft_params, frozen)
    return float(loss), float(acc), t_convert.llmsft_state_dict(
        jax.device_get(grads), unise.config.llm)


def assert_sft_matches(res, want_loss, want_acc, want_grads):
    np.testing.assert_allclose(float(res["loss"]), want_loss, rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(float(res["acc"]), want_acc, rtol=1e-5,
                               atol=1e-7)
    grads = {k[len("grad/"):]: v for k, v in res.items()
             if k.startswith("grad/")}
    rel_close(grads, want_grads, 1e-4, "LM gradients")


@pytest.fixture(scope="module")
def unise_pair():
    unise = tiny_train_unise_jax()
    return unise, port_unise(unise)


def write_scps(tmp_path):
    """3 speakers x 2 utterances of 0.5 s, a noise, an RIR."""
    from unified_audio_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(50)
    lines = []
    for spk in range(3):
        for u in range(2):
            path = tmp_path / f"s{spk}_{u}.wav"
            write_wav(path, (0.05 * rng.standard_normal(8000)
                             + 0.3 * np.sin(np.arange(8000) * (0.02 + 0.01
                                                               * spk))
                             ).astype(np.float32), 16000)
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
    return {"speech_scp": [str(tmp_path / "speech.scp")],
            "noise_scp": [str(tmp_path / "noise.scp")],
            "rir_scp": [str(tmp_path / "rir.scp")], "batch_size": 2,
            "cut_duration": [0.3, 0.5], "enroll_duration": 0.4,
            "num_workers": 4, "prefetch": 1, "samples_per_epoch": 16}


@pytest.fixture(scope="module")
def world4(unise_pair, tmp_path_factory):
    """One spawn of 4 ranks: the SFT step on dp2 x tp2 and on dp2 x pp2,
    the data iterator on dp2 x tp2, the hybrid meshes."""
    _, tunise = unise_pair
    arrays, cfgs = unise_arrays_and_cfgs(tunise)
    batch = sft_batch()
    arrays.update({f"batch.{k}": v for k, v in batch.items()})
    tmp = tmp_path_factory.mktemp("world4")
    sft = dict(kind="sft", cfgs=cfgs, task="tse", warmup=2)
    scenarios = [
        dict(sft, name="dp2tp2", mesh={"dp": 2, "tp": 2}),
        dict(sft, name="dp2pp2", mesh={"dp": 2, "pp": 2}, microbatches=2),
        dict(kind="data", name="data", mesh={"dp": 2, "tp": 2},
             dataset=write_scps(tmp), batches=3),
        dict(kind="hybrid", name="hybrid"),
    ]
    return spawn(tmp / "job", 4, scenarios, arrays), batch


@pytest.fixture(scope="module")
def jax_step(unise_pair, world4):
    unise, _ = unise_pair
    return jax_sft_step(unise, world4[1])


@pytest.mark.parametrize("name", ["dp2tp2", "dp2pp2"])
def test_sft_step_matches_jax_dense(world4, jax_step, name):
    """The sharded step's loss, accuracy (the dp average) and gradients
    (averaged over dp, gathered over tp / pp) equal JAX's dense step on
    the global batch of 4."""
    results, _ = world4
    assert_sft_matches(of(results[0], name), *jax_step)


@pytest.mark.parametrize("name", ["dp2tp2", "dp2pp2"])
def test_sft_step_ranks_agree(world4, name):
    """Every rank reports the same loss and gathers the same gradients and
    weights (replicated state stays replicated)."""
    results, _ = world4
    first = of(results[0], name)
    for r in results[1:]:
        other = of(r, name)
        assert set(other) == set(first)
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_tp_shards_attention_heads(world4, unise_pair):
    """At tp = 2 the weights come back whole in the reference layout:
    gathered, they equal the port's single-device weights (the first
    update runs at rate 0, as optax counts), so the q/k/v/gate/up rows and
    o/down columns were cut and put back in rank order."""
    results, _ = world4
    _, tunise = unise_pair
    got = of(results[0], "dp2tp2")
    for k, v in tunise.sft.state_dict().items():
        np.testing.assert_array_equal(got[f"param/{k}"], v.numpy(),
                                      err_msg=k)


def assert_peers_share_batches(data, peers, batches=3):
    """The ranks of each group in ``peers`` got the same ``batches``
    batches: task, mixture and target, bit for bit."""
    for group in peers:
        for r in group[1:]:
            for i in range(batches):
                for key in ("mode", "mix", "speech"):
                    np.testing.assert_array_equal(
                        data[r][f"{i}/{key}"], data[group[0]][f"{i}/{key}"],
                        err_msg=f"rank {r} batch {i} {key}")


def test_data_shards_by_dp_coordinate(world4):
    """On dp2 x tp2, with 4 loader threads a rank and random crop lengths,
    tp peers train on the same batches (``share_batches``) and the two dp
    ranks on different ones; the iterator's shard is (dp coordinate, dp
    size)."""
    results, _ = world4
    data = [of(r, "data") for r in results]
    # ranks 0, 1 are dp 0 (tp 0, 1); ranks 2, 3 dp 1
    assert [tuple(d["shard"]) for d in data] == [(0, 2), (0, 2), (1, 2),
                                                 (1, 2)]
    assert_peers_share_batches(data, ((0, 1), (2, 3)))
    assert not np.array_equal(data[0]["0/mix"], data[2]["0/mix"])


def test_hybrid_mesh(world4):
    """``make_hybrid_mesh`` at world 4: ici dp2 x tp2; dcn dp2 x ici
    (dp1, tp2) merges into dp 2 x tp 2 with the placement warning (one
    node), dp varying slowest; a wrong size raises ValueError."""
    results, _ = world4
    for rank, r in enumerate(results):
        h = of(r, "hybrid")
        assert list(h["flat_shape"]) == [2, 2]
        assert list(h["merged_shape"]) == [2, 2]
        assert list(h["merged_names"]) == ["dp", "tp"]
        assert bool(h["merged_warned"])
        assert list(h["coords"]) == [rank // 2, rank % 2]
        assert bool(h["wrong_size_raises"])


# ---------------------------------------------------------------------------
# No group needed
# ---------------------------------------------------------------------------

def test_initialize_single_process_noop(monkeypatch):
    """Without torchrun's environment and without arguments, ``initialize``
    joins nothing, as the JAX package's does for one process."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert t_dist.initialize() is False
    assert not torch.distributed.is_initialized()
    assert t_dist.initialize(num_processes=1) is False


def test_initialize_refuses_a_missing_card(monkeypatch):
    """NCCL is asked for with ``device="cuda"``; without a card that is an
    error, never a switch to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_dist.initialize("127.0.0.1:1", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()


def test_hybrid_mesh_wrong_size_raises():
    """The sizes are checked before any group is made."""
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        t_dist.make_hybrid_mesh(ici=dict(dp=3, tp=4), world_size=8)
    with pytest.raises(ValueError):
        t_dist.make_hybrid_mesh(ici=dict(dp=1, tp=4), dcn=dict(dp=3),
                                world_size=8)


def test_mesh_and_pp_mesh_exclusive(unise_pair):
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer

    _, tunise = unise_pair
    with pytest.raises(ValueError, match="not both"):
        SFTTrainer(tunise, mesh=object(), pp_mesh=object())


@pytest.mark.parametrize("tp,want", [(2, {"q": 0, "o": 1, "head": None,
                                          "embed": 1, "norm": None}),
                                     (4, {"q": 0, "o": 1, "head": None,
                                          "embed": 1, "norm": None}),
                                     (1, {"q": None, "o": None, "head": None,
                                          "embed": None, "norm": None})])
def test_lm_rules(tp, want):
    """JAX's LM rules on the port's names: q/k/v and gate/up cut by rows,
    o/down by columns, the embedding over D; the head's vocabulary (131 in
    the tiny LM, 12,291 at full width) is not divisible by 2 or 4 and
    stays replicated, as JAX drops an axis that does not divide."""
    names = {"q": ("layers.0.self_attn.q_proj.weight", (32, 32)),
             "o": ("layers.1.self_attn.o_proj.weight", (32, 32)),
             "head": ("output_head.weight", (131, 32)),
             "embed": ("codec_embedding.weight", (131, 32)),
             "norm": ("layers.0.input_layernorm.weight", (32,))}
    for key, (name, shape) in names.items():
        assert t_mesh.tp_dim_for(name, shape, tp) == want[key], name
    assert t_mesh.tp_dim_for("output_head.weight", (12291, 512), 2) is None
    assert t_mesh.tp_dim_for("output_head.weight", (12292, 512), 4) == 0
    for name in ("layers.3.mlp.gate_proj.weight", "layers.3.mlp.up_proj."
                 "weight", "layers.3.self_attn.k_proj.weight",
                 "layers.3.self_attn.v_proj.weight"):
        assert t_mesh.tp_dim_for(name, (128, 32), 2) == 0
    assert t_mesh.tp_dim_for("layers.3.mlp.down_proj.weight", (32, 128),
                             2) == 1
