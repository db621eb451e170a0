"""The Moonlight backbone on the card at its published widths (hidden 2048,
16 heads of MLA over 576-wide latent rows, 64 experts of 1408 top-6 with
2 shared), over 2 layers (the dense one and one MoE), bf16, 64 slots:

* the serving engine's step replayed as a CUDA graph gives the eager
  step's greedy and sampled tokens over one 5-s segment (283 steps);
* routed dispatch (the grouped GEMMs, at a decode step's 64 tokens and a
  prefill's 640) and dense dispatch of the same bf16 layer agree within
  bf16 rounding; the latent attention over a bf16 latent cache (the
  absorbed form) gives the naive form's output within bf16 rounding;
* an eager step makes no host sync (``torch.cuda.set_sync_debug_mode``
  "error" around it);
* every latent-attention call goes through K8: over a prefill and
  replayed steps the program counters read ``lm.mla.kernel`` =
  ``lm.mla.calls``, one call a layer a step, and K8's ``.launches``
  advance by the layers at each replay.

Needs a CUDA card; imports no JAX:

    python -m pytest tests/test_torch_moonlight_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from unified_audio_tpu_torch.models.lm.moonlight import MoonlightConfig
from unified_audio_tpu_torch.models.lm.sft import build_sft
from unified_audio_tpu_torch.nn.transformer import MoE, rope_cos_sin
from unified_audio_tpu_torch.ops.cuda.latent_attention import latent_attention
from unified_audio_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                                  Request, segment_chunks)
from unified_audio_tpu_torch.utils import profiling
from unified_audio_tpu_torch.utils.initialization import init_random_

SLOTS, FEATS, FRAMES = 64, 768, 250
STEPS = 32 + 1 + 250
CFG = MoonlightConfig(num_layers=2)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sft(card):
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device(card):
            model = build_sft(CFG, feats_dim=FEATS)
    finally:
        torch.set_default_dtype(torch.float32)
    init_random_(model, torch.Generator(device=card).manual_seed(3))
    with torch.no_grad():
        for layer in model.layers[1:]:
            layer.mlp.gate_bias.normal_(0.0, 0.02)
    return model.eval()


def _requests():
    rng = np.random.default_rng(11)
    return [Request(task_id=i % 2, mix_feats=rng.standard_normal(
                        (FRAMES, FEATS)).astype(np.float32),
                    enroll_feats=(rng.standard_normal((FRAMES, FEATS)).astype(
                        np.float32) if i % 2 else None),
                    do_sample=i % 2 == 0, uid=i)
            for i in range(SLOTS)]


def _engine(sft, graphed):
    eng = ContinuousBatchingEngine(sft, num_slots=SLOTS, max_global=32,
                                   max_semantic=256, mix_buckets=(256,))
    assert eng._graphed and list(eng.pool) == ["kv"]
    eng._graphed = graphed
    return eng


def _serve(eng, reqs, seed):
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    assert len(eng.admit_many(reqs)) == len(reqs)
    for c in segment_chunks(STEPS, 256):
        eng.step(c, gen)
    return {r.uid: r for r in eng.harvest()}


@pytest.mark.requires_cuda
def test_replayed_tokens_equal_eager(card, sft):
    reqs = _requests()
    got = {}
    for graphed in (True, False):
        eng = _engine(sft, graphed)
        got[graphed] = _serve(eng, reqs, seed=5)
        stats = eng.stats()
        if graphed:
            assert stats["graph_captures"] == 1
            assert stats["graph_replays"] == STEPS - 1
        del eng
        torch.cuda.empty_cache()
    for uid in range(SLOTS):
        np.testing.assert_array_equal(got[True][uid].global_ids,
                                      got[False][uid].global_ids)
        np.testing.assert_array_equal(got[True][uid].semantic_ids,
                                      got[False][uid].semantic_ids)


def _dense(moe, x):
    combine = moe.combine_weights(x).to(x.dtype)
    h = F.silu(torch.einsum("nd,edi->nei", x, moe.expert_w1)) * \
        torch.einsum("nd,edi->nei", x, moe.expert_w3)
    y = torch.einsum("ned,ne->nd",
                     torch.einsum("nei,eid->ned", h, moe.expert_w2), combine)
    return y + moe.shared_expert(x)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tokens", [64, 640])
def test_routed_equals_dense_dispatch_in_bf16(card, sft, tokens):
    """The bf16 layer's routed output (``torch._grouped_mm`` over each
    expert's rows) against dense dispatch of the same bf16 weights (every
    expert on every token, combined by the same fp32 router's weights):
    the same sums in other orders, within bf16 rounding; both against the
    fp32 dense layer no further than bf16 rounding."""
    moe = sft.layers[1].mlp
    assert isinstance(moe, MoE)
    x = torch.randn(tokens, CFG.hidden_size, device=card).bfloat16()
    with torch.no_grad():
        routed = moe(x[None])[0]
        dense = _dense(moe, x)
        exact = _dense(moe.float(), x.float())
        moe.to(torch.bfloat16)
    assert routed.dtype == torch.bfloat16
    assert _rel(routed, dense) < 2e-2
    assert _rel(routed, exact) < 2e-2 and _rel(dense, exact) < 2e-2


@pytest.mark.requires_cuda
def test_latent_cache_attention_equals_naive_in_bf16(card, sft):
    """Layer 1's latent attention in bf16: the absorbed form over a bf16
    latent cache (prefill of 39 positions, then one more through the
    cache) against the naive form over the 40 positions, within bf16
    rounding."""
    attn = sft.layers[1].self_attn
    x = torch.randn(2, 40, CFG.hidden_size, device=card).bfloat16()
    pos = torch.arange(40, device=card)
    cos, sin = rope_cos_sin(pos, CFG.rope_dim, CFG.rope_theta)
    mask = torch.where(pos[None] <= pos[:, None], 0.0, -1e9)
    with torch.no_grad():
        naive = attn(x, mask, cos, sin, None, 0)
        cache = {"kv": torch.zeros(1, 2, 40, CFG.latent_dim, device=card,
                                   dtype=torch.bfloat16), "index": 0}
        first = attn(x[:, :39], mask[:39], cos[:39], sin[:39], cache, 0)
        cache["index"] = torch.tensor([39, 39], device=card)
        last = attn(x[:, 39:], mask[39:][None, None], cos[39:], sin[39:],
                    cache, 0)
    assert _rel(torch.cat([first, last], 1), naive) < 2e-2


@pytest.mark.requires_cuda
def test_eager_step_makes_no_host_sync(card, sft):
    eng = _engine(sft, graphed=False)
    gen = torch.Generator(device=card).manual_seed(7)
    eng.admit_many(_requests())
    eng.step(1, gen)  # warm-up: the allocator's first blocks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._step_one(gen, eng._block_bound())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_every_latent_call_goes_through_k8(card, sft):
    eng = _engine(sft, graphed=True)
    gen = torch.Generator(device=card).manual_seed(9)
    steps = 8
    profiling.reset()
    profiling.enable()
    try:
        eng.admit_many(_requests())
        before = latent_attention.launches
        eng.step(steps, gen)
        torch.cuda.synchronize()
        counts = profiling.export()["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    stats = eng.stats()
    assert stats["graph_captures"] == 1
    assert stats["graph_replays"] == steps - 1
    layers = CFG.num_layers
    calls = layers * (stats["prefill_waves"] + steps)
    assert counts["lm.mla.calls"] == counts["lm.mla.kernel"] == calls
    assert latent_attention.launches - before == layers * steps
