"""The port's pipeline, sequence-parallel, pretraining and tensor-parallel
decode paths on 4 gloo ranks (``tests/torch_parallel_worker.py``), against
the JAX package's dense results on the same weights:

* ``llama_pipeline_forward`` at pp = 2 (on a dp2 x pp2 mesh, both dp
  groups on the same rows) and pp = 4 over a 4-layer LM, 4 microbatches:
  the normed output within 1e-5, and the gradients of mean(y^2) for every
  layer weight, the final norm and the input within 1e-5 of their largest
  entry; a microbatch count that does not divide the batch raises;
* ``llama_sequence_parallel_forward`` at sp = 4 over a 3-layer LM: within
  1e-5; a ragged sequence raises;
* one ``PretrainTrainer`` step on dp2 x tp2: loss within 1e-5 relative,
  accuracy exact, every gradient within 1e-4 of its largest entry;
* the paged decode step at tp = 4 (one head a rank), plain and owner
  modes: logits within 2e-4 and the pool within 2e-5, JAX's own bounds
  (``tests/test_parallel.py``);
* expert parallelism (``moe_ep``): HCodec's MoE ``Transformer`` (4
  experts, top-2, as ``tests/test_parallel.py TestExpertParallel``) on
  dp2 x tp2, two experts a rank: the output, the gradient of every
  parameter and of the input within 2e-5 of the same model run replicated
  on the whole batch (JAX's bound), and that run within 1e-4 of JAX's
  dense forward and gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import (jax_sft, port_config, random_variables,
                               tiny_lm_config)
from test_torch_parallel import of, rel_close, spawn
from unified_audio_tpu.models.lm.llama import CodecLM as JCodecLM
from unified_audio_tpu.models.lm.llama import LlamaBackbone, LlamaConfig
from unified_audio_tpu_torch.utils import convert as t_convert


def backbone_case(num_layers, b, s, seed):
    """A JAX backbone's seeded weights (port layout), an input, and the
    dense forward with the final norm."""
    cfg = LlamaConfig(global_size=16, semantic_size=32, hidden_size=32,
                      num_layers=num_layers, num_heads=4)
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, s, 32)).astype(np.float32)
    bb = LlamaBackbone(cfg)
    params = jax.device_get(random_variables(bb, embeds, seed=seed))
    sd = {}
    t_convert._backbone(params["params"], cfg, "", sd)
    return cfg, bb, params, embeds, sd


@pytest.fixture(scope="module")
def cases():
    pipe = backbone_case(4, 8, 12, 3)
    seq = backbone_case(3, 2, 24, 5)
    pcfg = LlamaConfig(global_size=16, semantic_size=40, hidden_size=32,
                       num_layers=2, num_heads=4)
    rng = np.random.default_rng(6)
    g = rng.integers(0, 16, (4, 6)).astype(np.int32)
    s = rng.integers(0, 40, (4, 20)).astype(np.int32)
    jm = JCodecLM(pcfg)
    pparams = jax.device_get(random_variables(jm, g, s, seed=7))
    return {"pipe": pipe, "seq": seq, "pretrain": (pcfg, jm, pparams, g, s),
            "paged": paged_case(), "moe": moe_case()}


MOE_KW = dict(hidden_size=16, intermediate_size=32, num_heads=4,
              num_layers=2, use_moe=True, moe_experts=4, moe_topk=2)


def moe_case():
    """JAX's MoE transformer of ``TestExpertParallel``, seeded weights and
    an (8, 6, 16) input."""
    from unified_audio_tpu.nn.transformer import Transformer

    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 6, 16)).astype(np.float32)
    jm = Transformer(**MOE_KW)
    return jm, jax.device_get(random_variables(jm, x, seed=10)), x


def paged_case():
    cfg = tiny_lm_config()
    sft, variables = jax_sft(cfg)
    rng = np.random.default_rng(8)
    s_slots, bs, mb = 3, 4, 4
    nb = 1 + s_slots * mb
    shape = (cfg.num_layers, nb, bs, cfg.num_heads * cfg.head_dim)
    pool = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    inputs = dict(
        tables=np.arange(1, 1 + s_slots * mb).reshape(s_slots, mb).astype(
            np.int32),
        index=np.array([5, 9, 0], np.int32), active=np.ones(s_slots, bool),
        ids=rng.integers(0, cfg.vocab_size, s_slots).astype(np.int32))
    return cfg, jax.device_get(variables), pool, inputs, bs


@pytest.fixture(scope="module")
def world4(cases, tmp_path_factory):
    arrays, scenarios = {}, []
    cfg, _, _, embeds, sd = cases["pipe"]
    arrays.update({f"pipe.backbone.{k}": np.asarray(v)
                   for k, v in sd.items()})
    arrays["pipe.embeds"] = embeds
    for name, mesh in (("pp2", {"dp": 2, "pp": 2}), ("pp4", {"pp": 4})):
        arrays.update({k.replace("pipe.", f"{name}.", 1): v
                       for k, v in list(arrays.items())
                       if k.startswith("pipe.")})
        scenarios.append(dict(kind="pipeline", name=name, mesh=mesh,
                              microbatches=4,
                              cfg=dataclasses.asdict(cfg)))
    cfg, _, _, embeds, sd = cases["seq"]
    arrays.update({f"sp4.backbone.{k}": np.asarray(v)
                   for k, v in sd.items()})
    arrays["sp4.embeds"] = embeds
    scenarios.append(dict(kind="sequence", name="sp4", mesh={"sp": 4},
                          cfg=dataclasses.asdict(cfg)))
    pcfg, _, pparams, g, s = cases["pretrain"]
    arrays.update({f"pretrain.lm.{k}": np.asarray(v) for k, v in
                   t_convert.llmsft_state_dict(
                       {"params": {"lm": pparams["params"]}}, pcfg).items()})
    arrays.update({"pretrain.g": g, "pretrain.s": s})
    scenarios.append(dict(kind="pretrain", name="pretrain",
                          mesh={"dp": 2, "tp": 2},
                          cfg=dataclasses.asdict(pcfg)))
    kcfg, variables, pool, inputs, _ = cases["paged"]
    arrays.update({f"paged.lm.{k}": np.asarray(v) for k, v in
                   t_convert.llmsft_state_dict(variables, kcfg).items()})
    arrays.update({f"paged.{k}": v for k, v in {**pool, **inputs}.items()})
    scenarios.append(dict(kind="paged", name="paged", mesh={"dp": 1,
                                                            "tp": 4},
                          cfg=dataclasses.asdict(kcfg), feats_dim=12))
    _, mvars, x = cases["moe"]
    arrays.update({f"moe.model.{k}": np.asarray(v) for k, v in
                   t_convert.transformer_state_dict(mvars).items()})
    arrays["moe.x"] = x
    scenarios.append(dict(kind="moe_ep", name="moe_ep",
                          mesh={"dp": 2, "tp": 2}, kw=MOE_KW))
    return spawn(tmp_path_factory.mktemp("layers") / "job", 4, scenarios,
                 arrays)


def _pipe_grads(cases):
    """JAX's dense mean(y^2) and its gradients (port layout)."""
    cfg, bb, params, embeds, _ = cases["pipe"]

    def loss(p, x):
        return jnp.mean(jnp.square(bb.apply(p, x)))

    y = bb.apply(params, embeds)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, embeds)
    sd = {}
    t_convert._backbone(jax.device_get(gp)["params"], cfg, "", sd)
    return np.asarray(y), sd, np.asarray(gx)


@pytest.mark.parametrize("name", ["pp2", "pp4"])
def test_pipeline_forward_matches_dense(world4, cases, name):
    y, _, _ = _pipe_grads(cases)
    for r in world4:
        np.testing.assert_allclose(of(r, name)["y"], y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["pp2", "pp4"])
def test_pipeline_grads_match_dense(world4, cases, name):
    """Every layer's gradient (gathered from its stage), the final norm's
    (the same on every rank, not multiplied by P) and the input's (summed
    over pp: it reaches stage 0 only) within 1e-5 of their largest
    entry."""
    _, want, gx = _pipe_grads(cases)
    for r in world4:
        res = of(r, name)
        got = {k[len("grad/"):]: v for k, v in res.items()
               if k.startswith("grad/")}
        rel_close(got, want, 1e-5, name)
        rel_close({"x": res["embeds_grad"]}, {"x": gx}, 1e-5, name)


@pytest.mark.parametrize("name", ["pp2", "pp4"])
def test_pipeline_bad_microbatch_raises(world4, name):
    """8 rows do not split into 3 microbatches: ValueError, before any
    collective."""
    assert all(bool(of(r, name)["bad_microbatches_raises"]) for r in world4)


def test_sequence_parallel_forward_matches_dense(world4, cases):
    _, bb, params, embeds, _ = cases["seq"]
    y = np.asarray(bb.apply(params, embeds))
    for r in world4:
        np.testing.assert_allclose(of(r, "sp4")["y"], y, atol=1e-5, rtol=0)


def test_sequence_parallel_rejects_ragged(world4):
    assert all(bool(of(r, "sp4")["ragged_raises"]) for r in world4)


def test_pretrain_step_dp_tp_matches_jax_dense(world4, cases):
    """One dp2 x tp2 ``PretrainTrainer`` step (2 rows a dp rank) against
    JAX's dense pretraining loss and gradients on the 4 rows."""
    pcfg, jm, pparams, g, s = cases["pretrain"]
    (loss, acc), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, g, s), has_aux=True))(pparams)
    want = t_convert.llmsft_state_dict(
        {"params": {"lm": jax.device_get(grads)["params"]}}, pcfg)
    for r in world4:
        res = of(r, "pretrain")
        assert abs(float(res["loss"]) - float(loss)) <= 1e-5 * abs(
            float(loss))
        assert abs(float(res["acc"]) - float(acc)) <= 1e-7
        got = {k[len("grad/"):]: v for k, v in res.items()
               if k.startswith("grad/")}
        rel_close(got, want, 1e-4, "pretrain gradients")


@pytest.mark.parametrize("mode", ["plain", "owner"])
def test_paged_decode_tp_matches_unsharded(world4, cases, mode):
    """The decode step at tp = 4 (each rank one head of 8 lanes and its
    pool rows; ``o_proj`` and the MLP summed over tp) against JAX's
    unsharded ``paged_decode_ids``: logits within 2e-4, the pool within
    2e-5."""
    from unified_audio_tpu.serve.paged import paged_decode_ids

    cfg, variables, pool, inputs, bs = cases["paged"]
    logits, new_pool = paged_decode_ids(
        cfg, variables["params"]["lm"], {k: jnp.asarray(v)
                                         for k, v in pool.items()},
        *(jnp.asarray(inputs[k]) for k in ("tables", "index", "active",
                                           "ids")), bs)
    for r in world4:
        res = of(r, "paged")
        assert int(res[f"{mode}/heads"]) == 1
        np.testing.assert_allclose(res[f"{mode}/logits"],
                                   np.asarray(logits), atol=2e-4, rtol=0)
        for k in ("k", "v"):
            np.testing.assert_allclose(res[f"{mode}/{k}"],
                                       np.asarray(new_pool[k]), atol=2e-5,
                                       rtol=0)


def test_port_config_roundtrip():
    """The worker rebuilds configs from JSON: a tuple field comes back a
    tuple and the LM config equals the port's."""
    import json

    from torch_parallel_worker import config, llama_config

    cfg = tiny_lm_config()
    assert llama_config(json.loads(json.dumps(
        dataclasses.asdict(cfg)))) == port_config(cfg)
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import SSLConfig

    ssl = SSLConfig(conv_dim=(16,) * 7)
    back = config(SSLConfig, json.loads(json.dumps(dataclasses.asdict(ssl))))
    assert back == ssl and isinstance(back.conv_dim, tuple)


def test_expert_parallel_matches_replicated(world4):
    """The experts really are cut (2 of 4 a rank); the dp2 x tp2 output
    and every gradient (the experts' gathered over tp, the gate's and the
    shared expert's whole on each rank, the input's) within 2e-5 of the
    replicated run."""
    for r in world4:
        res = of(r, "moe_ep")
        assert int(res["local_experts"]) == 2
        np.testing.assert_allclose(res["ep/y"], res["ref/y"], atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(res["ep/x_grad"], res["ref/x_grad"],
                                   atol=2e-5, rtol=0)
        ep = {k[len("ep/grad/"):]: v for k, v in res.items()
              if k.startswith("ep/grad/")}
        ref = {k[len("ref/grad/"):]: v for k, v in res.items()
               if k.startswith("ref/grad/")}
        assert set(ep) == set(ref) and any("expert_w1" in k for k in ep)
        for k, v in ref.items():
            np.testing.assert_allclose(ep[k], v, atol=2e-5, rtol=0,
                                       err_msg=k)


def test_expert_parallel_reference_matches_jax(world4, cases):
    """The replicated run the EP run is held to equals JAX's dense MoE
    transformer: forward within 1e-4, gradients within 1e-4 of their
    largest entry."""
    jm, variables, x = cases["moe"]

    def loss(v, xx):
        return jnp.mean(jnp.square(jm.apply(v, xx)))

    y = np.asarray(jm.apply(variables, x))
    gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables, x)
    want = t_convert.transformer_state_dict(jax.device_get(gv))
    want = {k: v for k, v in want.items() if not k.endswith("gate_bias")}
    res = of(world4[0], "moe_ep")
    np.testing.assert_allclose(res["ref/y"], y, atol=1e-4, rtol=0)
    got = {k[len("ref/grad/"):]: v for k, v in res.items()
           if k.startswith("ref/grad/")}
    rel_close(got, want, 1e-4, "moe gradients")
    rel_close({"x": res["ref/x_grad"]}, {"x": np.asarray(gx)}, 1e-4, "x")
