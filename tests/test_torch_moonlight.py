"""The Moonlight-16B-A3B backbone (``models/lm/moonlight.py``), the routed
``MoE`` dispatch and the latent paged pool, on the CPU at a tiny Moonlight
shape (hidden 64, 4 heads, kv_lora 32, rope 16, nope 16, v 16, 8 experts
top-2 with 2 shared, 3 layers of which layer 0 is dense), fp32, on seeded
weights made as the benchmark makes them (``portbench/harness/
layered.py``) in the plain reference (``portbench/reference/
unise_moonlight16b.py``) and handed to the port:

* the backbone's full forward logits against the reference's (naive MLA,
  dense experts), and prefill then teacher-forced decode through the
  latent paged pool (owner regions and scattered block tables) against
  the reference's logits at the same positions: within 2e-5 of the
  largest logit (fp32 sums in other orders: the absorbed against the
  naive attention, routed against dense experts);
* the absorbed latent decode against the naive MLA over the same
  sequence, within 1e-5;
* routed dispatch against dense dispatch of the same ``MoE`` (every expert
  on every token, combined by ``combine_weights``), forward and
  gradients; the grouped GEMMs against per-expert products; and
  under expert parallelism, the E/tp shares' outputs with the shared
  expert counted once summing to the uncut layer's;
* a UniSE segment served through ``ContinuousBatchingEngine`` (waveform
  in, WavLM at admission, the latent pool, greedy and sampled rows): the
  greedy codes equal ``LLMSFT.generate``'s over a dense latent cache;
* two ``SFTTrainer`` steps of UniSE on the backbone: the routed LM's
  gradients equal the dense-dispatch LM's within 1e-5 of their largest
  entry.
"""
import copy
import dataclasses
from argparse import Namespace

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from portbench.harness import layered, weights
from portbench.harness.context import Run
from portbench.reference import unise_moonlight16b as reference
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.models.bicodec.bicodec import (BiCodec,
                                                            BiCodecConfig)
from unified_audio_tpu_torch.models.bicodec.tokenizer import BiCodecTokenizer
from unified_audio_tpu_torch.models.lm.moonlight import (LatentAttention,
                                                         MoonlightConfig)
from unified_audio_tpu_torch.models.lm.sft import MoonlightSFT, build_sft
from unified_audio_tpu_torch.models.ssl.wav2vec2 import (SSLConfig,
                                                         Wav2Vec2Model)
from unified_audio_tpu_torch.models.unise.model import (UniSE, UniSEConfig,
                                                        lm_config)
from unified_audio_tpu_torch.nn import transformer as t_tr
from unified_audio_tpu_torch.parallel import mesh as t_mesh
from unified_audio_tpu_torch.serve import paged
from unified_audio_tpu_torch.serve.engine import Request
from unified_audio_tpu_torch.train.optim import Optimizer
from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer
from unified_audio_tpu_torch.utils.initialization import init_random_

FD = 24
SIZES = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
             v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
             n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
             first_k_dense_replace=1, routed_scaling_factor=2.446,
             rms_norm_eps=1e-5, rope_theta=50000.0, vocab_size=160,
             global_size=64, semantic_size=64)
CFG = MoonlightConfig(
    global_size=64, semantic_size=64, vocab_size=160, hidden_size=64,
    num_layers=3, num_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=16, v_head_dim=16, intermediate_size=96,
    moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
    n_shared_experts=2)


def close(got, want, rel, what=""):
    err = float((got - want).detach().abs().max())
    assert err <= rel * float(want.abs().max()), (what, err)


@pytest.fixture(scope="module")
def pair():
    """(reference LM, its layer maker, the port's MoonlightSFT) on the same
    seeded weights, handed over as the benchmark hands them."""
    torch.manual_seed(0)
    run = Run(torch, Namespace(seed=11, seconds=0.0, trace=0), {}, {}, {},
              reference, device="cpu")
    lm = reference.LM(SIZES, FD)
    weights.fill_(torch, lm, run.generator(1))
    ref = Namespace(lm=lm, make_layer=layered.layer_maker(run, SIZES,
                                                          torch.float32))
    with torch.device("meta"):
        sft = build_sft(CFG, num_tasks=3, feats_dim=FD)
    sft = sft.to_empty(device="cpu")
    layered.hand_over(torch, ref, sft)
    return lm, ref.make_layer, sft.eval()


def embeds(n, t, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, t, 64, generator=g)


def reference_logits(pair, x):
    lm, make, _ = pair
    with torch.no_grad():
        return torch.stack([lm.output_head(h) for h in
                            lm.hidden(list(x), make)])


def test_config_and_model():
    """The YAML section names the stack; the SFT LM is Moonlight's, its
    pool a latent one."""
    cfg = lm_config({"backbone": "moonlight", **{
        f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}})
    assert cfg == CFG
    assert isinstance(build_sft(cfg, feats_dim=FD), MoonlightSFT)
    pool = paged.init_pool(CFG, 4, 8, dtype=torch.bfloat16)
    assert list(pool) == ["kv"] and pool["kv"].shape == (3, 4, 8, 48)
    with pytest.raises(ValueError, match="latent pool"):
        paged.init_pool(CFG, 4, 8, quant="int8")
    with pytest.raises(ValueError, match="cannot hold"):
        MoonlightConfig(global_size=64, semantic_size=64, vocab_size=128)


def test_backbone_logits_equal_reference(pair):
    x = embeds(2, 20, 1)
    with torch.no_grad():
        got = pair[2].head(pair[2].backbone(x))
    close(got, reference_logits(pair, x), 2e-5)


@pytest.mark.parametrize("mode", ["owner", ""])
def test_prefill_and_latent_decode_equal_reference(pair, mode):
    """Two slots at different depths: a dense prefill scattered into the
    latent pool (``scatter_cache``), then teacher-forced steps of
    ``paged_decode_ids`` (owner: contiguous regions; plain: scattered
    blocks), each step's logits against the reference's full forward."""
    sft = pair[2]
    bs, steps, lens = 8, 6, (9, 5)
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 160, (2, max(lens) + steps), generator=g)
    want = reference_logits(pair, sft.codec_embedding(ids).detach())
    tables = (torch.tensor([[4, 5, 6, 7], [8, 9, 10, 11]]) if mode
              else torch.tensor([[3, 12, 1, 7], [10, 2, 14, 5]]))
    pool = paged.init_pool(CFG, 16, bs)
    active = torch.ones(2, dtype=torch.bool)
    with torch.no_grad():
        for b, n in enumerate(lens):
            cache = sft.init_cache(1, n)
            sft.prefill(sft.codec_embedding(ids[b:b + 1, :n]), cache)
            paged.scatter_cache(pool, tables[b:b + 1], cache, bs)
        index = torch.tensor(lens, dtype=torch.int32)
        for k in range(steps):
            logits = paged.paged_decode_ids(
                CFG, sft, pool, tables.int(), index, active,
                ids[torch.arange(2), index.long()], bs, use_kernel=mode)
            for b in range(2):
                close(logits[b], want[b, index[b]], 2e-5, (mode, k, b))
            index = index + 1


def test_absorbed_decode_equals_naive():
    torch.manual_seed(4)
    attn = LatentAttention(CFG).eval()
    x = torch.randn(2, 11, 64)
    pos = torch.arange(11)
    cos, sin = t_tr.rope_cos_sin(pos, CFG.rope_dim, CFG.rope_theta)
    mask = torch.where(pos[None] <= pos[:, None], 0.0, -1e9)
    with torch.no_grad():
        naive = attn(x, mask, cos, sin, None, 0)
        cache = {"kv": torch.zeros(1, 2, 11, CFG.latent_dim), "index": 0}
        first = attn(x[:, :10], mask[:10], cos[:10], sin[:10], cache, 0)
        cache["index"] = torch.tensor([10, 10])
        last = attn(x[:, 10:], mask[10:][None, None], cos[10:], sin[10:],
                    cache, 0)
    close(torch.cat([first, last], 1), naive, 1e-5)


def dense_forward(moe, x):
    """Every expert on every token, combined by ``combine_weights``: the
    JAX package's dispatch."""
    combine = moe.combine_weights(x).to(x.dtype)
    h = F.silu(torch.einsum("...d,edi->...ei", x, moe.expert_w1)) * \
        torch.einsum("...d,edi->...ei", x, moe.expert_w3)
    y = torch.einsum("...ed,...e->...d",
                     torch.einsum("...ei,eid->...ed", h, moe.expert_w2),
                     combine)
    return y + moe.shared_expert(x)


def moe_layer(seed=5):
    torch.manual_seed(seed)
    moe = t_tr.MoE(64, 32, 8, 2, 2, 2.446, "sigmoid")
    with torch.no_grad():
        moe.gate_bias.normal_(0, 0.05)
    return moe


def test_routed_equals_dense_dispatch():
    moe = moe_layer()
    x = torch.randn(3, 7, 64, requires_grad=True)
    y = moe(x)
    close(y, dense_forward(moe, x), 1e-6)
    grads = torch.autograd.grad(y.square().mean(), [x, *moe.parameters()],
                                allow_unused=True)
    want = torch.autograd.grad(dense_forward(moe, x).square().mean(),
                               [x, *moe.parameters()], allow_unused=True)
    for (name, _), g, w in zip([("x", x), *moe.named_parameters()], grads,
                               want):
        if w is None:
            assert g is None, name
        else:
            close(g, w, 1e-5, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_experts_equal_per_expert_runs(dtype, monkeypatch):
    """The experts' grouped GEMMs (``grouped_mm``: one
    ``torch._grouped_mm`` a weight, the path of prefill and of the
    graph-captured step) and its per-run fallback give each expert's
    products over its run of rows, empty experts included, in the stack's
    dtype."""
    moe = moe_layer().to(dtype)
    counts = torch.tensor([3, 0, 5, 1, 0, 4, 2, 1], dtype=torch.int32)
    experts = torch.repeat_interleave(torch.arange(8), counts.long())
    xs = torch.randn(int(counts.sum()), 64).to(dtype)
    with torch.no_grad():
        got = moe.experts(xs, counts)
        want = torch.cat([
            (F.silu(xs[experts == j] @ moe.expert_w1[j])
             * (xs[experts == j] @ moe.expert_w3[j]))
            @ moe.expert_w2[j] for j in range(8)])
        monkeypatch.delattr(torch, "_grouped_mm")
        looped = moe.experts(xs, counts)
    assert got.dtype == looped.dtype == dtype
    close(got.float(), want.float(), 1e-6 if dtype == torch.float32 else 2e-2)
    close(looped.float(), want.float(), 1e-6)


def test_expert_parallel_shares_add_up(monkeypatch):
    """tp = 2 shares of the expert stack, each routing over all 8 experts
    and computing its 4 experts' part (the exchange stubbed out): their
    outputs, the shared expert counted once, add up to the uncut layer's
    and to the dense dispatch's."""
    moe = moe_layer(6)
    x = torch.randn(2, 9, 64)
    monkeypatch.setattr(t_mesh, "copy_to_group", lambda t, g: t)
    monkeypatch.setattr(t_mesh, "reduce_from_group", lambda t, g: t)
    tp, outs = 2, []
    with torch.no_grad():
        full = moe(x)
        for r in range(tp):
            share = copy.deepcopy(moe)
            for name in ("expert_w1", "expert_w3", "expert_w2"):
                w = torch.nn.Parameter(getattr(moe, name)[r * 4:(r + 1) * 4]
                                       .clone())
                w.tp_dim = 0
                setattr(share, name, w)
            share.tp_group = object()
            monkeypatch.setattr(torch.distributed, "get_rank",
                                lambda group=None, r=r: r)
            outs.append(share(x))
        shared = moe.shared_expert(x)
    close(sum(outs) - (tp - 1) * shared, full, 1e-6)
    close(full, dense_forward(moe, x), 1e-6)


@pytest.fixture(scope="module")
def unise(pair):
    """A tiny UniSE on the Moonlight LM: tiny WavLM, tokenizing BiCodec
    over a tiny XLSR, random from a seed."""
    wavlm = Wav2Vec2Model(SSLConfig(
        hidden_size=FD, num_layers=2, num_heads=4, intermediate_size=32,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, use_rel_pos_bias=True,
        num_buckets=32, max_distance=80))
    xlsr = Wav2Vec2Model(SSLConfig(
        hidden_size=16, num_layers=17, num_heads=2, intermediate_size=32,
        conv_dim=(16,) * 7, conv_bias=True, feat_extract_norm="layer",
        do_stable_layer_norm=True, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4))
    bicodec = BiCodec(BiCodecConfig(
        ref_segment_duration=0.2, feat_dim=16, vocos_dim=32,
        vocos_intermediate_dim=64, vocos_num_layers=1, latent_dim=32,
        codebook_size=64, codebook_dim=8, spk_out_dim=32, spk_latent_dim=16,
        token_num=4, fsq_levels=(4, 4, 4), num_mels=32, mel_n_fft=256,
        mel_win=160, mel_hop=80, wave_channels=32), tokenize=True)
    gen = torch.Generator().manual_seed(7)
    for m in (wavlm, xlsr, bicodec):
        init_random_(m, gen).eval()
    sft = copy.deepcopy(pair[2])
    cfg = UniSEConfig(segment_seconds=0.4, feats_dim=FD, global_tokens=4,
                      llm=CFG)
    return UniSE(cfg, BiCodecTokenizer(bicodec, xlsr), wavlm, sft)


def test_engine_serves_unise_segment(unise):
    """A greedy and a sampled TSE segment, waveforms in, through the
    engine ``cli serve`` builds: the greedy codes equal ``generate``'s
    (the dense latent cache), the sampled ones lie in their ranges."""
    eng = cli.make_engine(unise, slots=2)
    assert list(eng.pool) == ["kv"] and eng.use_kernel == ""
    rng = np.random.default_rng(8)
    seg = unise.config.segment_len
    mix, enroll = (0.3 * rng.standard_normal((2, seg))).astype(np.float32)
    sem = unise._semantic_len()
    kw = dict(task_id=1, mix_wav=mix, enroll_wav=enroll, global_length=4,
              semantic_length=sem)
    out = eng.run([Request(uid=0, do_sample=False, **kw),
                   Request(uid=1, **kw)],
                  torch.Generator().manual_seed(9))
    feats = unise.wavlm_feats(torch.as_tensor(np.stack([enroll, mix])))
    g, s = unise.sft.generate(1, feats[:1], feats[1:], global_length=4,
                              semantic_length=sem, do_sample=False)
    np.testing.assert_array_equal(out[0].global_ids, g[0].numpy())
    np.testing.assert_array_equal(out[0].semantic_ids, s[0].numpy())
    assert ((out[1].semantic_ids >= 0) & (out[1].semantic_ids < 64)).all()
    wav = unise._decode_tokens(out[0].global_ids[None],
                               out[0].semantic_ids[None], seg)
    assert wav.shape == (seg,) and np.isfinite(wav).all()


def test_sft_training_steps(unise, monkeypatch):
    """``SFTTrainer`` on the backbone: the routed LM's gradients equal the
    dense-dispatch LM's on the same batch; two steps change the weights
    and keep the loss finite."""
    u = copy.copy(unise)
    u.sft = copy.deepcopy(unise.sft).train()
    rng = np.random.default_rng(10)
    wav = torch.as_tensor(0.3 * rng.standard_normal((3, 2, 6400)),
                          dtype=torch.float32)
    trainer = SFTTrainer(u, Optimizer(u.sft.parameters(), lr=1e-3))
    frozen = u.frozen_inputs(wav[0], wav[1], wav[2])
    trainer.loss_backward("tse", frozen)
    routed = {n: p.grad.clone() for n, p in u.sft.named_parameters()
              if p.grad is not None}
    u.sft.zero_grad(set_to_none=True)
    monkeypatch.setattr(t_tr.MoE, "forward", dense_forward)
    trainer.loss_backward("tse", frozen)
    monkeypatch.undo()
    assert any("expert_w" in n for n in routed)
    for n, p in u.sft.named_parameters():
        if n in routed:
            close(routed[n], p.grad, 1e-5, n)
    before = {n: p.detach().clone() for n, p in u.sft.named_parameters()}
    for _ in range(2):
        loss, _ = trainer.train_step("tse", wav[0], wav[1], wav[2])
        assert np.isfinite(float(loss))
    assert any(not torch.equal(before[n], p) for n, p in
               u.sft.named_parameters())
