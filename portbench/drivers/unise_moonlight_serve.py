"""UniSE serving on the Moonlight-16B-A3B backbone, in the unise serving
cell's closed loop (``unise_serve.py``: its traffic, loop, window and
release), through the same engine (``cli.make_engine``), the LM built as
``cli serve --config configs/unise_moonlight16b.yaml`` builds it: the
Moonlight stack in bf16 (weights, activations and the latent pool), its
router in fp32.

What differs is the size. The stack is 15.4 B parameters: the program's
copy is made on the card in bf16 with its values unset and filled from
the reference one layer at a time (``harness/layered.py``), and the
reference never holds more than one fp32 layer. Its check reads what
the unise cell's reads (the served greedy codes' and sampled codes'
reference logits, the waveforms), with the reference's stack run once
over every sampled segment, a layer at a time, but it takes the mean of
each code's gap over the sample where the unise cell takes the widest:
with 64 experts top-6 a token's 6th and 7th scores lie close, so bf16
rounding moves some tokens to other experts, and their logits with them,
by an amount the fp32 reference cannot predict token by token. The widest
gap is that chaotic tail (bf16 and fp8 programs overlap on it); the mean
over ~2,000 codes is stable from seed to seed and grows with the
precision's error. The per-layer counts are Moonlight's
(``harness/moe_counts.py``).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from portbench.drivers import unise_serve as base
from portbench.harness import closed_loop, layered, moe_counts, weights
from portbench.harness.peaks import bound_s

# the program's MoonlightConfig keys that the published config names
# otherwise
RENAMED = {"num_layers": "num_hidden_layers",
           "num_heads": "num_attention_heads"}


def _port():
    p = base._port()
    from unified_audio_tpu_torch.models.lm.moonlight import MoonlightConfig
    from unified_audio_tpu_torch.models.lm.sft import build_sft
    p.MoonlightConfig, p.build_sft = MoonlightConfig, build_sft
    return p


def program_config(p, sizes: dict):
    """The program's ``MoonlightConfig`` of the configuration's sizes."""
    import dataclasses

    return p.MoonlightConfig(**{
        f.name: sizes[RENAMED.get(f.name, f.name)]
        for f in dataclasses.fields(p.MoonlightConfig)
        if RENAMED.get(f.name, f.name) in sizes})


def build(run, p):
    """-> (reference, the port's UniSE): WavLM, BiCodec and the LM's
    resident part made from the seed in the reference's modules, the
    layers one at a time, the LM's weights rounded to its served dtype
    (``layered.round_``), all handed to the port's modules."""
    torch, cfg, dev = run.torch, run.config, run.device
    tup = run.reference._tuples
    p.cli._fp32_without_tf32()
    torch.manual_seed(run.seed % 2 ** 63)
    with torch.device(dev):
        ref = run.reference.UniSEMoonlightReference(cfg, None)
    served = getattr(torch, cfg["dtypes"]["lm_served"])
    weights.fill_(torch, ref, run.generator(1))
    layered.round_(torch, ref.lm, served)
    ref.eval().requires_grad_(False)
    ref.make_layer = layered.layer_maker(run, ref.sizes, served)
    mcfg = program_config(p, ref.sizes)
    with torch.device("meta"):
        sft = p.build_sft(mcfg, num_tasks=len(p.TASK_MAP),
                          feats_dim=cfg["unise"]["feats_dim"])
    sft = sft.to(served).to_empty(device=dev)
    layered.hand_over(torch, ref, sft)
    with torch.device(dev):
        wavlm = p.Wav2Vec2Model(p.SSLConfig(**tup(cfg["wavlm"])))
        bicodec = p.BiCodec(p.BiCodecConfig(**tup(cfg["bicodec"])),
                            tokenize=False)
    for r, m in ((ref.wavlm, wavlm), (ref.bicodec, bicodec)):
        weights.hand_over(r, m)
    for m in (sft, wavlm, bicodec):
        m.eval().requires_grad_(False)
    unise = p.UniSE(p.UniSEConfig(**cfg["unise"], llm=mcfg),
                    p.BiCodecTokenizer(bicodec, None), wavlm, sft)
    return ref, unise


class ServingLoop(base.ServingLoop):
    """The unise cell's loop, counting Moonlight's operations: each
    prefill token's and each decode token's (``moe_counts.token_flops``),
    and in the profiled wave each step's least time, its bytes over the
    HBM rate (``moe_counts.step_bytes``)."""

    def __init__(self, run, st, traffic):
        self.run, self.st, self.tr = run, st, traffic
        self.in_window = self.profiling = False
        self.reqs = {}
        self.sizes = run.reference.lm_sizes(run.config)
        self.elem = run.torch.finfo(getattr(
            run.torch, run.config["dtypes"]["lm_served"])).bits // 8
        self.loop = closed_loop.ClosedLoop(
            run.cell["traffic"]["clients"], traffic.plan, traffic.sr,
            self._requests, self._finish, traffic.steps)

    def on_admit(self, uids):
        if not self._counting():
            return
        c = self.sizes
        feats = self.run.config["unise"]["feats_dim"]
        for uid in uids:
            req = self.reqs[uid]
            n = self.tr.prompt_len[uid]
            frames = n - 2 - (0 if req.enroll_wav is None else 1)
            self.run.count("wavlm_segments", 1 + (req.enroll_wav is not None))
            self.run.count("lm_flops_bf16", sum(
                moe_counts.token_flops(c, i + 1, head=False)
                for i in range(n)) + 2 * c["hidden_size"] * c["vocab_size"]
                + 2 * feats * c["hidden_size"] * frames)

    def on_chunk(self, n):
        if not self._counting():
            return
        run, c = self.run, self.sizes
        live = [self.tr.prompt_len[uid] + done
                for uid, (_, done) in self.loop.live.items()]
        flops = 0
        for k in range(n):
            ctxs = [d + k + 1 for d in live]
            flops += sum(moe_counts.token_flops(c, x) for x in ctxs)
            if self.profiling:
                moved = moe_counts.step_bytes(c, ctxs, self.elem)
                ops = sum(moe_counts.token_flops(c, x) for x in ctxs)
                run.count("step_least_s", bound_s(moved, ops, "bf16")[0])
                run.count("profiled_steps", 1)
        run.count("lm_flops_bf16", flops)


def setup(run):
    p = _port()
    torch = run.torch
    ref, unise = build(run, p)
    if run.device != "cpu":
        ref.to("cpu")  # back on the card for the check, after the window
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng = p.cli.make_engine(unise, slots=run.cell["slots"])
    st = SimpleNamespace(p=p, ref=ref, unise=unise, eng=eng,
                         gen=run.generator(2))
    traffic = base.Traffic(run, p, unise)
    g = np.zeros((1, traffic.global_len), np.int32)
    s = np.zeros((1, traffic.semantic_len), np.int32)
    for n in range(1, -(-int(run.cell["traffic"]["max_seconds"] * traffic.sr)
                        // traffic.seg) + 1):
        unise._decode_tokens(np.repeat(g, n, 0), np.repeat(s, n, 0), 1)
    st.serving = ServingLoop(run, st, traffic)
    st.serving.loop.start()
    eng.prestage(st.serving.loop.pending)
    for _ in range(run.cell["warm_waves"]):
        st.serving.turn()
    return st


window = base.window
release = base.release


def check(run, st, out, control: bool = False):
    """The unise cell's readings (``unise_serve.check``) on a sample of the
    completed utterances drawn from the seed, each code's gap averaged over
    the sample (module docstring), the reference's stack run once over all
    the sampled segments. ``control``: the reference's
    LM in fp8 in the program's place, putting its own code first or
    drawing its own code from its own support; BiCodec's decoder with TF32
    on."""
    torch, dev = run.torch, run.device
    c = run.cell["check"]
    vocab = run.config["codec_vocab"]
    ref = st.ref.to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done = out["completed"]
    rng = np.random.default_rng(run.seed % 2 ** 32 + 17)

    def sample(items, k):
        if not items:
            return []
        longest = max(items, key=lambda u: u.n_samples)
        rest = [u for u in items if u is not longest]
        k = min(k - 1, len(rest))
        picked = [rest[i] for i in rng.choice(len(rest), k, replace=False)]
        return [longest] + picked

    greedy = [(req, utt.outputs[req.uid]) for utt in sample(
        [u for u in done if u.greedy], c["greedy_utterances"])
        for req in utt.requests]
    sampled = [(req, utt.outputs[req.uid]) for utt in sample(
        [u for u in done if not u.greedy], c["sampled_utterances"])
        for req in utt.requests]

    def logits():
        items = [(req.task_id, _t(torch, req.mix_wav, dev).float(),
                  None if req.enroll_wav is None
                  else _t(torch, req.enroll_wav, dev).float(),
                  _t(torch, res.global_ids, dev),
                  _t(torch, res.semantic_ids, dev))
                 for req, res in greedy + sampled]
        return ref.code_logits(items)

    with torch.no_grad():
        want = logits()
        pick = [None] * len(want)
        if control:
            ref.lm.set_precision("fp8")
            pick = logits()
            ref.lm.set_precision("fp32")
        greedy_gaps = [run.reference.gaps(
            *lg, _t(torch, res.global_ids, dev),
            _t(torch, res.semantic_ids, dev), vocab, pick=alt)
            for (req, res), lg, alt in zip(greedy, want, pick)]
        draw = torch.Generator(device=dev).manual_seed(run.seed % 2 ** 63)
        sampled_gaps = [run.reference.support_gaps(
            *lg, _t(torch, res.global_ids, dev),
            _t(torch, res.semantic_ids, dev), vocab, req.top_k, req.top_p,
            pick=None if alt is None else (*alt, req.temperature, draw))
            for (req, res), lg, alt in zip(sampled, want[len(greedy):],
                                           pick[len(greedy):])]
        gap, n_tokens = _mean(torch, greedy_gaps, c["min_tokens"])
        support, n_sampled = _mean(torch, sampled_gaps, c["min_tokens"])
        err = 0.0
        for utt in sample(done, c["waveform_utterances"]):
            gl = _t(torch, np.stack([utt.outputs[r.uid].global_ids
                                     for r in utt.requests]), dev)
            sl = _t(torch, np.stack([utt.outputs[r.uid].semantic_ids
                                     for r in utt.requests]), dev)
            w = ref.detokenize(gl, sl).reshape(-1)[:utt.n_samples]
            got = utt.wav
            if control:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                got = ref.detokenize(gl, sl).reshape(-1)[:utt.n_samples]
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                got = got.double().cpu().numpy()
            w = w.double().cpu().numpy()
            err = max(err, float(np.linalg.norm(got - w)
                                 / max(np.linalg.norm(w), 1e-30)))
        if run.trace and not control:
            base._count_fp32(run, ref)
    run.records["tokens_compared"] = n_tokens + n_sampled
    return [{"name": "logit_gap_mean", "value": gap,
             "limit": c["logit_gap_mean"]},
            {"name": "support_gap_mean", "value": support,
             "limit": c["support_gap_mean"]},
            {"name": "waveform_rel_err", "value": err,
             "limit": c["waveform_rel_err"]}]


def _mean(torch, gaps, min_tokens: int):
    """-> (the mean of the codes' gaps, their count); inf where fewer than
    ``min_tokens`` codes are there to judge (a code outside its range reads
    inf already)."""
    if not gaps:
        return float("inf"), 0
    flat = torch.cat(gaps).double()
    n = flat.numel()
    return (float(flat.mean()) if n >= min_tokens else float("inf")), n


_t = base._t

