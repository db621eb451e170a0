"""The port's continuous-batching engine against the JAX package.

Greedy requests (SE, TSE and rTSE, one with a mix shorter than its bucket)
outnumber the slots, so slots and pool regions are recycled. With the float
pool every result equals JAX ``LLMSFT.generate``'s greedy tokens exactly;
with the int8 pool every result equals a JAX reference loop over the same
int8 paged pool (JAX prefill, ``scatter_prefill``, ``paged_decode_ids``).
The attention runs in the owner mode (the K1/K2 plain versions on the CPU),
the stream mode (the K3/K4 plain versions) and the plain mode.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_sft, port_sft, tiny_lm_config
from unified_audio_tpu.models.lm.llama import init_cache, range_mask
from unified_audio_tpu.serve import paged as j_paged
from unified_audio_tpu_torch.serve import profile_step
from unified_audio_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                                  Request, graph_steps_on)
from unified_audio_tpu_torch.utils import profiling

FD = 12  # feature dim
GLEN, SLEN, BS = 4, 6, 8


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config()
    sft, variables = jax_sft(cfg, feats_dim=FD)
    return cfg, sft, variables, port_sft(cfg, variables, feats_dim=FD)


def _requests():
    rng = np.random.default_rng(7)
    enroll = rng.standard_normal((6, FD)).astype(np.float32)
    spec = [(0, 10, None), (1, 10, enroll), (0, 7, None), (2, 10, enroll),
            (0, 10, None)]
    return [Request(task_id=t, mix_feats=rng.standard_normal(
                        (n, FD)).astype(np.float32),
                    enroll_feats=e, global_length=GLEN, semantic_length=SLEN,
                    do_sample=False, uid=uid)
            for uid, (t, n, e) in enumerate(spec)]


def _engine(tsft, **kw):
    return ContinuousBatchingEngine(
        tsft, num_slots=2, block_size=BS, max_global=8, max_semantic=16,
        mix_buckets=(10, 16), **kw)


def _jax_generate(generate, variables, req):
    enr = None if req.enroll_feats is None else \
        jnp.asarray(req.enroll_feats)[None]
    g, s = generate(variables, jnp.int32(req.task_id), enr,
                    jnp.asarray(req.mix_feats)[None])
    return np.asarray(g[0]), np.asarray(s[0])


def _jax_int8_paged(cfg, sft, variables, req):
    """Greedy two-phase decode of one request over a JAX int8 paged pool."""
    enr = None if req.enroll_feats is None else \
        jnp.asarray(req.enroll_feats)[None]
    prompt = sft.apply(variables, req.task_id, enr,
                       jnp.asarray(req.mix_feats)[None], method="_prompt")
    n = prompt.shape[1]
    cache = init_cache(cfg, 1, n)
    _, cache = sft.apply(variables, prompt, cache,
                         method=lambda m, p, c: m.lm.prefill(p, c))
    tables = jnp.arange(1, 6, dtype=jnp.int32)[None]
    pool = j_paged.init_pool(cfg, 8, BS, quant="int8")
    pool = j_paged.scatter_prefill(pool, tables, cache["k"], cache["v"], BS)
    lm_params = variables["params"]["lm"]
    step = jax.jit(j_paged.paged_decode_ids, static_argnums=(0, 7))
    out, idx, active = [], n, jnp.asarray([True])
    for mask, first, steps in (
            (range_mask(cfg, cfg.global_offset, cfg.global_size),
             cfg.global_sos, GLEN + 1),
            (range_mask(cfg, cfg.semantic_offset, cfg.semantic_size),
             cfg.semantic_sos, SLEN)):
        ids, toks = jnp.asarray([first], jnp.int32), []
        for _ in range(steps):
            logits, pool = step(cfg, lm_params, pool, tables,
                                jnp.asarray([idx], jnp.int32), active, ids,
                                BS)
            ids = jnp.argmax(logits + mask, -1).astype(jnp.int32)
            toks.append(int(ids[0]))
            idx += 1
        out.append(np.asarray(toks))
    return (out[0][:GLEN] - cfg.global_offset,
            out[1] - cfg.semantic_offset)


@pytest.fixture(scope="module")
def float_ref(lm):
    cfg, sft, variables, _ = lm
    generate = jax.jit(lambda v, t, e, m: sft.apply(
        v, t, e, m, jax.random.PRNGKey(0), method="generate",
        global_length=GLEN, semantic_length=SLEN, do_sample=False))
    return {r.uid: _jax_generate(generate, variables, r) for r in _requests()}


@pytest.fixture(scope="module")
def int8_ref(lm):
    cfg, sft, variables, _ = lm
    return {r.uid: _jax_int8_paged(cfg, sft, variables, r)
            for r in _requests()[:3]}


@pytest.mark.parametrize("mode", ["owner", "stream", ""])
def test_greedy_float_pool_matches_generate(lm, float_ref, mode):
    reqs = _requests()
    eng = _engine(lm[3], use_kernel=mode)
    results = eng.run(reqs)
    assert sorted(results) == [r.uid for r in reqs]
    for r in reqs:
        g, s = float_ref[r.uid]
        np.testing.assert_array_equal(results[r.uid].global_ids, g)
        np.testing.assert_array_equal(results[r.uid].semantic_ids, s)
    st = eng.stats()
    assert st["requests_completed"] == len(reqs)
    assert st["tokens_generated"] == len(reqs) * (GLEN + 1 + SLEN)
    assert st["blocks_held"] == 0 and st["prefill_waves"] >= 3


@pytest.mark.parametrize("mode", ["owner", "stream", ""])
def test_greedy_int8_pool_matches_paged_reference(lm, int8_ref, mode):
    reqs = _requests()[:3]
    results = _engine(lm[3], use_kernel=mode, kv_quant="int8").run(reqs)
    for r in reqs:
        g, s = int8_ref[r.uid]
        np.testing.assert_array_equal(results[r.uid].global_ids, g)
        np.testing.assert_array_equal(results[r.uid].semantic_ids, s)


@pytest.mark.parametrize("mode", ["owner", "stream", ""])
def test_state_and_pool_keep_their_storage(lm, float_ref, mode):
    """Every state and pool tensor keeps its storage across admission,
    steps, a cancel, a displacing admission, the stash drain and harvest
    (a captured step replays on the same storage), and the greedy tokens
    stay those of JAX's generate."""
    eng = _engine(lm[3], use_kernel=mode)

    def storage():
        return {(part, k): v.data_ptr() for part, d in
                (("state", eng.state), ("pool", eng.pool))
                for k, v in d.items()}

    reqs, steps = _requests(), GLEN + 1 + SLEN
    want = storage()
    calls = [lambda: eng.admit_many(reqs[:2]), lambda: eng.step(3),
             lambda: eng.cancel(reqs[1].uid), lambda: eng.step(steps - 3),
             lambda: eng.admit_many(reqs[2:4]), lambda: eng.step(steps),
             eng.drain_stashes, eng.harvest,
             lambda: eng.admit_many(reqs[4:]), lambda: eng.step(steps),
             eng.harvest]
    results = {}
    for call in calls:
        out = call()
        if isinstance(out, list) and out and hasattr(out[0], "uid"):
            results.update((r.uid, r) for r in out)
        assert storage() == want, call
    assert sorted(results) == [0, 2, 3, 4]
    for uid, r in results.items():
        g, s = float_ref[uid]
        np.testing.assert_array_equal(r.global_ids, g)
        np.testing.assert_array_equal(r.semantic_ids, s)


def test_steps_replay_only_on_the_card_and_uncut(lm):
    """The decode step is a CUDA graph replay only on a CUDA device with
    the LM whole: eager on the CPU (no capture, no replay, no
    ``engine.graph_steps`` count) and under a tensor-parallel cut."""
    tsft = lm[3]
    assert graph_steps_on(torch.device("cuda"), tsft)
    assert not graph_steps_on(torch.device("cpu"), tsft)
    cut = copy.deepcopy(tsft)
    for layer in cut.layers:  # rank 0 of tp = 2, as shard_lm_ cuts it
        for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                     layer.self_attn.v_proj):
            proj.weight.data = proj.weight.data[
                :proj.weight.shape[0] // 2].contiguous()
    assert cut.layers[0].self_attn.local_heads == tsft.cfg.num_heads // 2
    assert not graph_steps_on(torch.device("cuda"), cut)

    eng = _engine(tsft)
    assert not eng._graphed
    eng.admit_many(_requests()[:2])
    profiling.reset()
    profiling.enable()
    try:
        eng.step(4)
        counts = profiling.export()["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    st = eng.stats()
    assert (st["decode_steps"], st["graph_captures"],
            st["graph_replays"]) == (4, 0, 0)
    assert "engine.graph_steps" not in counts


def test_mode_follows_device(lm):
    """On the CPU the engine picks the plain attention; the owner mode
    brings the region allocator and region-sized pool."""
    tsft = lm[3]
    assert _engine(tsft).use_kernel == ""
    eng = _engine(tsft, use_kernel="owner")
    ra = eng.allocator
    assert ra.region_blocks % 14 == 0 and ra.region_blocks >= eng.max_blocks
    assert eng.num_blocks % 64 == 0


def test_sampled_requests_stay_in_range(lm):
    cfg, _, _, tsft = lm
    reqs = _requests()
    for r in reqs[::2]:
        r.do_sample, r.top_k, r.temperature = True, 5, 0.9
    results = _engine(tsft).run(reqs, torch.Generator().manual_seed(0))
    for r in results.values():
        assert r.global_ids.shape == (GLEN,) and r.semantic_ids.shape == (SLEN,)
        assert 0 <= r.global_ids.min() and r.global_ids.max() < cfg.global_size
        assert 0 <= r.semantic_ids.min() and \
            r.semantic_ids.max() < cfg.semantic_size


@pytest.mark.parametrize("bad", [dict(global_length=99),
                                 dict(semantic_length=0),
                                 dict(temperature=0.0), dict(top_p=1.5),
                                 dict(top_k=0), dict(mix_feats=None)])
def test_validate_rejects(lm, bad):
    req = _requests()[0]
    for k, v in bad.items():
        setattr(req, k, v)
    with pytest.raises(ValueError):
        _engine(lm[3]).validate(req)


def test_profile_window_runs_engine_steps(lm, monkeypatch):
    """The step profiler's window runs its timed and its profiled steps on
    the engine; on the CPU the profiler sees no device activity, so the
    device numbers read None (not measured) instead of zero."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    eng = _engine(lm[3])
    eng.admit_many(_requests()[:2])
    rec = profile_step._window(eng, None, 2)
    assert eng.stats()["decode_steps"] == 4
    assert rec["step_ms"] > 0 and rec["cached_tokens_min"] >= 1
    assert rec["device_ms_per_step"] is None
    assert rec["device_busy_share"] is None and rec["top_kernels"] == []


def test_profile_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        profile_step.main([])
