"""UniTok-audio, port vs JAX: the delay pattern, the prompt, the solo
generate, the continuous-batching engine (plain, stream and owner
attention; fp32 and int8 pools) and the pool shared with the UniSE engine.
The pipeline over the HCodec-1.0 tokenizer is held to JAX in
tests/test_torch_hcodec.py, the weight bridge in tests/test_torch_convert.py.

The JAX tiny config of tests/test_unitok_engine.py (codebook 17, 2 streams
of 2 quantizers, hidden 32, 2 layers, 4 heads), fp32, inputs from a numpy
seed, weights carried across by ``unitok_state_dict``. Greedy codes must
equal JAX's exactly: its solo ``generate`` for the float pool, a JAX
reference loop over a JAX int8 pool through ``paged_decode_embeds(
use_kernel="stream")`` (K4 in interpret mode) for the int8 pool. Floats
within atol/rtol 1e-4. Sampled rows cannot match JAX's PRNG, so their
structure is checked instead. The JAX engine itself is not run (its tests
are in the slow tier).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (TOL, jax_sft, port_config, port_sft,
                               random_variables, to_torch)
from unified_audio_tpu.models.lm.llama import LlamaConfig, init_cache
from unified_audio_tpu.models.unitok import delay as j_delay
from unified_audio_tpu.models.unitok.model import UniTokConfig, UniTokLM
from unified_audio_tpu.serve import paged as j_paged
from unified_audio_tpu_torch.models.unitok import delay as t_delay
from unified_audio_tpu_torch.models.unitok import model as t_model
from unified_audio_tpu_torch.serve import paged as t_paged
from unified_audio_tpu_torch.serve import profile_step
from unified_audio_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                                  Request)
from unified_audio_tpu_torch.serve.unitok_engine import (UniTokEngine,
                                                         UniTokRequest)
from unified_audio_tpu_torch.utils.convert import unitok_state_dict

BS = 8
# (task, frames, caption frames, reference frames, input frames)
SPEC = [(0, 5, None, None, 4), (3, 7, None, 6, 5), (4, 6, 3, None, 7),
        (1, 4, None, 3, 8), (5, 6, None, None, 3), (2, 5, None, None, 8)]


def tiny_cfg():
    return UniTokConfig(codebook_size=17, num_quantizers=2, num_streams=2,
                        hidden_size=32, num_layers=2, num_heads=4,
                        text_dim=8, audio_dim=8, max_positions=512)


def port_unitok(cfg, variables):
    lm = t_model.UniTokLM(t_model.UniTokConfig(**dataclasses.asdict(cfg)))
    lm.load_state_dict(to_torch(unitok_state_dict(variables, cfg)))
    return lm.eval()


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_cfg()
    jlm = UniTokLM(cfg)
    variables = jax.device_get(random_variables(
        jlm, 0, np.zeros((1, 3, cfg.text_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 6, cfg.num_codebooks), np.int32), seed=5))
    return cfg, jlm, variables, port_unitok(cfg, variables)


def _requests(do_sample=False):
    rng = np.random.default_rng(11)

    def feats(n, dim):
        return None if n is None else rng.standard_normal(
            (n, dim)).astype(np.float32)

    return [UniTokRequest(task_id=t, num_frames=nf,
                          caption_feats=feats(c, 8), ref_feats=feats(r, 8),
                          input_feats=feats(i, 8), do_sample=do_sample,
                          uid=uid)
            for uid, (t, nf, c, r, i) in enumerate(SPEC)]


def _batch(x):
    return None if x is None else jnp.asarray(x)[None]


def _jax_generate(jlm, variables, req):
    return np.asarray(jlm.apply(
        variables, req.task_id, _batch(req.caption_feats),
        _batch(req.ref_feats), _batch(req.input_feats), req.num_frames,
        jax.random.PRNGKey(1), do_sample=False, method="generate"))[0]


@pytest.fixture(scope="module")
def solo(lm):
    cfg, jlm, variables, _ = lm
    return {r.uid: _jax_generate(jlm, variables, r) for r in _requests()}


def _engine(tlm, **kw):
    base = dict(num_slots=2, block_size=BS, max_frames=16,
                feat_buckets=(4, 8))
    base.update(kw)
    return UniTokEngine(tlm, **base)


class TestModel:
    def test_delay_matches_jax(self):
        codes = np.random.default_rng(2).integers(0, 100, (2, 7, 4))
        want = j_delay.apply_delay(jnp.asarray(codes), pad_token=999)
        got = t_delay.apply_delay(torch.as_tensor(codes), pad_token=999)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            t_delay.undo_delay(got).numpy(),
            np.asarray(j_delay.undo_delay(want)))

    def test_build_prompt_matches_jax(self, lm):
        cfg, jlm, variables, tlm = lm
        rng = np.random.default_rng(3)
        cap = rng.standard_normal((2, 3, cfg.text_dim)).astype(np.float32)
        ref = rng.standard_normal((2, 5, cfg.audio_dim)).astype(np.float32)
        inp = rng.standard_normal((2, 4, cfg.audio_dim)).astype(np.float32)
        for segs in ((cap, ref, inp), (None, None, inp), (cap, None, inp)):
            want = jlm.apply(variables, 4, *[_j(x) for x in segs], 2,
                             method="build_prompt")
            with torch.no_grad():
                got = tlm.build_prompt(4, *[_t(x) for x in segs], 2)
                # per-row task ids give each row its own task embedding
                rows = tlm.build_prompt(torch.tensor([4, 1]),
                                        *[_t(x) for x in segs], 2)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_array_equal(rows[0].numpy(), got[0].numpy())
            np.testing.assert_array_equal(
                rows[1, 0].numpy(),
                tlm.task_embedding.weight[1].detach().numpy())

    def test_generate_greedy_matches_jax(self, lm, solo):
        cfg, _, _, tlm = lm
        for r in _requests()[:3]:
            got = tlm.generate(r.task_id, _t1(r.caption_feats),
                               _t1(r.ref_feats), _t1(r.input_feats),
                               r.num_frames, do_sample=False)
            assert got.shape == (1, r.num_frames, cfg.num_codebooks)
            np.testing.assert_array_equal(got[0].numpy(), solo[r.uid])

    def test_generate_sampled_stays_in_range(self, lm):
        cfg, _, _, tlm = lm
        r = _requests()[1]
        got = tlm.generate(r.task_id, None, _t1(r.ref_feats),
                           _t1(r.input_feats), 6,
                           torch.Generator().manual_seed(0), top_k=5)
        assert got.shape == (1, 6, cfg.num_codebooks)
        assert 0 <= int(got.min()) and int(got.max()) < cfg.codebook_size


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _t1(x):
    return None if x is None else torch.as_tensor(x)[None]


class TestEngine:
    @pytest.mark.parametrize("mode", ["", "stream", "owner"])
    def test_greedy_matches_solo_generate(self, lm, solo, mode):
        """Mixed tasks and lengths, caption and reference segments, six
        requests through two slots: slots and blocks are recycled. The
        owner mode runs K1/K2's plain versions on a RegionAllocator."""
        reqs = _requests()
        eng = _engine(lm[3], use_kernel=mode)
        results = eng.run(reqs)
        assert sorted(results) == [r.uid for r in reqs]
        for r in reqs:
            np.testing.assert_array_equal(results[r.uid].codes, solo[r.uid])
        st = eng.stats()
        assert st["requests_completed"] == len(reqs)
        assert st["blocks_held"] == 0 and st["prefill_waves"] >= 3
        assert st["attention"] == (mode or "plain")

    def test_int8_stream_matches_jax_paged_loop(self, lm):
        cfg, jlm, variables, tlm = lm
        reqs = _requests()[:3]
        results = _engine(tlm, use_kernel="stream", kv_quant="int8").run(reqs)
        for r in reqs:
            np.testing.assert_array_equal(
                results[r.uid].codes,
                _jax_int8_stream(cfg, jlm, variables, r))

    def test_sampled_rows_keep_the_delay_window(self, lm):
        """Sampled codes stay in the codebook after undo_delay, and every
        delayed position outside a codebook's window is PAD."""
        cfg, _, _, tlm = lm
        reqs = _requests(do_sample=True)[:2]
        eng = _engine(tlm)
        eng.admit_wave([reqs[0]])
        eng.admit_wave([reqs[1]])
        gen = torch.Generator().manual_seed(0)
        for _ in range(max(r.num_frames for r in reqs) + cfg.num_codebooks):
            eng.step(generator=gen)
        out = eng.state["out"].numpy()
        for slot, r in enumerate(reqs):
            for k in range(cfg.num_codebooks):
                col = out[slot, :r.num_frames + cfg.num_codebooks - 1, k]
                window = np.arange(len(col))
                inside = (window >= k) & (window < k + r.num_frames)
                assert (col[~inside] == cfg.pad).all()
                assert (col[inside] < cfg.codebook_size).all()
        for res in eng.harvest():
            assert res.codes.shape == (reqs[res.uid].num_frames,
                                       cfg.num_codebooks)
            assert 0 <= res.codes.min() and \
                res.codes.max() < cfg.codebook_size

    def test_geometry_and_mode_policy(self, lm):
        """At the engine's serving geometry (16 slots, 64-token blocks,
        buckets up to 256, 256 frames) a table spans 17 blocks and the
        stream pool holds 320; on the CPU the plain attention is the
        default, and the owner mode brings a region allocator."""
        tlm = lm[3]
        eng = UniTokEngine(tlm, num_slots=16, use_kernel="stream")
        assert eng.max_blocks == 17 and eng.num_blocks == 320
        assert isinstance(eng.allocator, t_paged.BlockAllocator)
        assert UniTokEngine(tlm, num_slots=2).use_kernel == ""
        owner = UniTokEngine(tlm, num_slots=2, use_kernel="owner")
        assert isinstance(owner.allocator, t_paged.RegionAllocator)
        assert owner.allocator.region_blocks % 14 == 0

    @pytest.mark.parametrize("bad", [dict(temperature=0.0), dict(top_p=1.5),
                                     dict(top_k=0), dict(num_frames=0),
                                     dict(num_frames=99),
                                     dict(input_feats=np.zeros((9, 8)))])
    def test_validate_rejects(self, lm, bad):
        eng = _engine(lm[3])
        req = dataclasses.replace(_requests()[0], **bad)
        free = len(eng.allocator.free)
        with pytest.raises(ValueError):
            eng.admit_wave([_requests()[4], req])
        assert eng.free_slots() == [0, 1] and len(eng.allocator.free) == free


_J_DECODE = jax.jit(j_paged.paged_decode_embeds, static_argnums=(0, 7),
                    static_argnames=("num_active_blocks", "use_kernel"))


def _jax_int8_stream(cfg, jlm, variables, req):
    """Greedy decode of one request over a JAX int8 paged pool: JAX
    prefill, ``scatter_prefill``, then ``paged_decode_embeds`` in the
    stream mode (K4 in interpret mode), the stacked heads and the delay
    window, as the JAX engine's step does."""
    lcfg = cfg.llama_config
    k_books = cfg.num_codebooks
    prompt = jlm.apply(variables, req.task_id, _batch(req.caption_feats),
                       _batch(req.ref_feats), _batch(req.input_feats), 1,
                       method="build_prompt")
    n = prompt.shape[1]
    cache = init_cache(lcfg, 1, n)
    _, cache = jlm.apply(variables, prompt, cache,
                         method=lambda m, p, c: m.backbone.prefill(p, c))
    steps = req.num_frames + k_books - 1
    n_blk = math.ceil((n + steps + 1) / BS)
    # one table width for every request: one compiled decode step
    tables = jnp.zeros((1, 15), jnp.int32).at[0, :n_blk].set(
        jnp.arange(1, n_blk + 1, dtype=jnp.int32))
    pool = j_paged.init_pool(lcfg, 16, BS, quant="int8")
    pool = j_paged.scatter_prefill(pool, tables, cache["k"], cache["v"], BS)
    p = variables["params"]
    emb = [jnp.asarray(p[f"code_embed_{k}"]["embedding"])
           for k in range(k_books)]
    heads = jnp.stack([p[f"head_{k}"]["kernel"] for k in range(k_books)])
    vocab = jnp.arange(cfg.layer_vocab)
    code_mask = jnp.where(vocab < cfg.codebook_size, 0.0, -1e9)
    pad_only = jnp.where(vocab == cfg.pad, 0.0, -1e9)
    ids, out = [cfg.bos] * k_books, []
    for step in range(steps):
        x = emb[0][ids[0]]
        for k in range(1, k_books):
            x = x + emb[k][ids[k]]
        hidden, pool = _J_DECODE(lcfg, p["backbone"], pool, tables,
                              jnp.asarray([n + step], jnp.int32),
                              jnp.asarray([True]), x[None, None], BS,
                              num_active_blocks=16, use_kernel="stream")
        logits = jnp.einsum("sd,kdv->skv", hidden, heads)[0]
        masks = [code_mask if k <= step < k + req.num_frames else pad_only
                 for k in range(k_books)]
        ids = [int(jnp.argmax(logits[k] + masks[k])) for k in range(k_books)]
        out.append(ids)
    delayed = np.asarray(out)
    codes = np.stack([delayed[k:k + req.num_frames, k]
                      for k in range(k_books)], axis=-1)
    return np.clip(codes, 0, cfg.codebook_size - 1)


def test_shared_pool_with_unise(lm):
    """A UniSE engine and a UniTok engine in the stream mode on one pool
    and one BlockAllocator, stepped in turn: disjoint blocks, and both
    results equal their JAX solo generates (the port of
    tests/test_unitok_engine.py TestSharedPool)."""
    ucfg, jlm, uvars, tlm = lm
    lcfg = LlamaConfig(global_size=32, semantic_size=64, hidden_size=32,
                       num_layers=2, num_heads=4, max_position_embeddings=512)
    sft, sft_vars = jax_sft(lcfg, feats_dim=8, seed=6)
    tsft = port_sft(lcfg, sft_vars, feats_dim=8)
    bs, num_blocks = 16, 41
    pool_ref = t_paged.PoolRef(t_paged.init_pool(port_config(lcfg),
                                                 num_blocks, bs))
    alloc = t_paged.BlockAllocator(num_blocks)
    eng_u = ContinuousBatchingEngine(
        tsft, num_slots=2, block_size=bs, max_global=4, max_semantic=16,
        mix_buckets=(8,), use_kernel="stream", pool_ref=pool_ref,
        allocator=alloc)
    eng_t = UniTokEngine(tlm, num_slots=2, block_size=bs, max_frames=16,
                         feat_buckets=(8,), use_kernel="stream",
                         pool_ref=pool_ref, allocator=alloc)
    assert eng_u.pool is eng_t.pool

    rng = np.random.default_rng(4)
    mixf = rng.standard_normal((5, 8)).astype(np.float32)
    solo_g, solo_s = sft.apply(sft_vars, 0, None, jnp.asarray(mixf[None]),
                               jax.random.PRNGKey(3), global_length=4,
                               semantic_length=6, do_sample=False,
                               method="generate")
    req_t = UniTokRequest(task_id=2, num_frames=6, do_sample=False, uid=200,
                          input_feats=rng.standard_normal(
                              (4, 8)).astype(np.float32))
    solo_t = _jax_generate(jlm, uvars, req_t)

    eng_u.admit_many([Request(task_id=0, mix_feats=mixf, global_length=4,
                              semantic_length=6, do_sample=False, uid=100)])
    eng_t.admit_wave([req_t])
    held_u = {b for bl in eng_u._slot_blocks for b in bl}
    held_t = {b for bl in eng_t._slot_blocks for b in bl}
    assert held_u and held_t and not held_u & held_t
    for _ in range(20):
        eng_u.step()
        eng_t.step()
    res_u = {r.uid: r for r in eng_u.harvest()}
    res_t = {r.uid: r for r in eng_t.harvest()}
    np.testing.assert_array_equal(res_u[100].global_ids,
                                  np.asarray(solo_g)[0])
    np.testing.assert_array_equal(res_u[100].semantic_ids,
                                  np.asarray(solo_s)[0])
    np.testing.assert_array_equal(res_t[200].codes, solo_t)
    assert len(alloc.free) == num_blocks - 1


def test_profile_window_runs_unitok_steps(lm, monkeypatch):
    """The step profiler drives the UniTok engine's decode steps in the
    stream mode; on the CPU its device numbers read None (not measured),
    and ``--model unitok`` needs a card."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    eng = _engine(lm[3], use_kernel="stream")
    eng.admit_wave(_requests()[:1])
    rec = profile_step._window(eng, None, 2, eng.state["active"])
    assert eng.stats()["decode_steps"] == 4
    assert rec["cached_tokens_min"] >= 1 and rec["step_ms"] > 0
    assert rec["device_ms_per_step"] is None
    assert rec["attention_kernel_us_per_call"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        profile_step.main(["--model", "unitok"])
