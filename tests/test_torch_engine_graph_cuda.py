"""The serving engine's decode step replayed as a CUDA graph, on the card,
against the same engine stepping eagerly: UniSE's LM at full width (512 x
12, bf16), 64 slots, one full 5-s segment (32 + 1 + 250 = 283 steps) in
``segment_chunks`` of at most 256, mixed greedy and sampled rows. Greedy
rows give the eager step's tokens in the owner mode over a bf16 pool (K1)
and an int8 pool (K2) and in the stream mode (K3); two replays from one
state draw different samples; the kernel wrappers' ``.launches`` advance by
the captured launches a replay. Needs a CUDA card; imports no JAX:

    python -m pytest tests/test_torch_engine_graph_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from unified_audio_tpu_torch.models.lm.llama import LlamaConfig
from unified_audio_tpu_torch.models.lm.sft import LLMSFT
from unified_audio_tpu_torch.ops.cuda import paged_attention as t_pa
from unified_audio_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                                  Request, segment_chunks)
from unified_audio_tpu_torch.utils.initialization import init_random_

SLOTS, FEATS, FRAMES = 64, 768, 250
STEPS = 32 + 1 + 250  # one 5-s segment: global_length + 1 + semantic_length


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sft(card):
    model = LLMSFT(LlamaConfig(), feats_dim=FEATS).to(card)
    init_random_(model, torch.Generator(device=card).manual_seed(3))
    return model.to(torch.bfloat16).eval()


def _requests(sample_every=2):
    """SE and TSE rows; every ``sample_every``-th row sampled at ``cli
    serve``'s defaults, the others greedy."""
    rng = np.random.default_rng(11)
    return [Request(task_id=i % 2, mix_feats=rng.standard_normal(
                        (FRAMES, FEATS)).astype(np.float32),
                    enroll_feats=(rng.standard_normal((FRAMES, FEATS)).astype(
                        np.float32) if i % 2 else None),
                    do_sample=i % sample_every == 0, uid=i)
            for i in range(SLOTS)]


def _engine(sft, graphed, **kw):
    eng = ContinuousBatchingEngine(sft, num_slots=SLOTS, max_global=32,
                                   max_semantic=256, mix_buckets=(256,),
                                   **kw)
    assert eng._graphed
    eng._graphed = graphed
    return eng


def _serve(eng, reqs, seed):
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    assert len(eng.admit_many(reqs)) == len(reqs)
    for c in segment_chunks(STEPS, 256):
        eng.step(c, gen)
    return {r.uid: r for r in eng.harvest()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode,quant,kernel", [
    ("owner", None, t_pa.paged_flash_decode_owner),
    ("owner", "int8", t_pa.paged_flash_decode_owner_q8),
    ("stream", None, t_pa.paged_flash_decode_stream_flat)])
def test_replayed_greedy_tokens_equal_eager(card, sft, mode, quant, kernel):
    """One segment through the graph engine and through the eager one:
    equal greedy tokens; one capture, every step after the first a
    replay; the kernel counted once a layer a step either way."""
    reqs = _requests()
    got = {}
    for graphed in (False, True):
        eng = _engine(sft, graphed, use_kernel=mode, kv_quant=quant)
        before = kernel.launches
        got[graphed] = _serve(eng, reqs, seed=5)
        torch.cuda.synchronize()
        assert kernel.launches - before == sft.cfg.num_layers * STEPS
        st = eng.stats()
        assert st["decode_steps"] == STEPS
        assert (st["graph_captures"], st["graph_replays"]) == (
            (1, STEPS - 1) if graphed else (0, 0))
    assert sorted(got[True]) == [r.uid for r in reqs]
    for r in reqs:
        if r.do_sample:
            continue
        a, b = got[False][r.uid], got[True][r.uid]
        np.testing.assert_array_equal(a.global_ids, b.global_ids)
        np.testing.assert_array_equal(a.semantic_ids, b.semantic_ids)
    same = sum(np.array_equal(got[False][r.uid].semantic_ids,
                              got[True][r.uid].semantic_ids)
               for r in reqs if r.do_sample)
    print(f"{mode} {quant or 'bf16'}: {same} of {SLOTS // 2} sampled rows "
          "drew the eager step's tokens")


@pytest.mark.requires_cuda
def test_replays_draw_fresh_samples_and_count_launches(card, sft):
    """From one state, two replays with the registered generator: the
    greedy rows take the same token, the sampled rows draw anew; each
    replay adds the captured launches (one K1 call a layer)."""
    eng = _engine(sft, True)
    reqs = _requests(sample_every=4)
    gen = torch.Generator(device=card).manual_seed(9)
    eng.admit_many(reqs)
    eng.step(2, gen)  # the eager first step, then capture and one replay
    assert eng.stats()["graph_captures"] == 1
    saved = {k: v.clone() for k, v in eng.state.items()}
    ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    drawn = []
    for _ in range(2):
        for k, v in saved.items():
            eng.state[k].copy_(v)
        before = t_pa.paged_flash_decode_owner.launches
        eng.step(1, gen)
        assert t_pa.paged_flash_decode_owner.launches - before == \
            sft.cfg.num_layers
        drawn.append(eng.state["last_ids"].cpu().numpy())
    assert {k: v.data_ptr() for k, v in eng.state.items()} == ptrs
    sampled = np.array([r.do_sample for r in reqs])
    np.testing.assert_array_equal(drawn[0][~sampled], drawn[1][~sampled])
    differ = (drawn[0][sampled] != drawn[1][sampled]).mean()
    print(f"two replays from one state: {differ:.2%} of the sampled rows "
          "drew another token")
    assert differ > 0.5
    assert eng.stats()["graph_replays"] == 3
