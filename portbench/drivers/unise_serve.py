"""UniSE serving in a closed loop through the port's continuous-batching
engine (``cli.make_engine``: one 5-s segment bucket, WavLM at admission,
the int16 waveform wire, the LM cast to bf16 as ``cli serve`` casts it).

Clients send utterances cut into 5-s segments (wrap-padded, as ``cli
serve`` cuts them); the window turns ``harness/closed_loop.cycle``
(``admit_many``, ``step(n)`` in ``segment_chunks`` up to the next
completion, ``harvest``) and detokenizes each utterance whose segments are
all back with ``UniSE._decode_tokens``, as ``cli serve`` does. It closes at
the first completion after ``--seconds``; the rate is the audio of the
utterances completed over the window's time.

Once the program's state is freed, samples of the completed utterances
(the longest among them) are held to the plain reference: of the greedy
ones, every served code's reference logit against the best of its range;
of the sampled ones, every served code's reference logit against the least
of the reference's top-k/top-p support; and the waveforms against the
reference's decoding of the same codes.
"""
from __future__ import annotations

import gc
import sys
import time
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace

import numpy as np

from portbench.harness import audio, closed_loop, counts, weights
from portbench.harness.peaks import bound_s


def _port():
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.models.bicodec.bicodec import (
        BiCodec, BiCodecConfig)
    from unified_audio_tpu_torch.models.bicodec.tokenizer import (
        BiCodecTokenizer)
    from unified_audio_tpu_torch.models.lm.llama import LlamaConfig
    from unified_audio_tpu_torch.models.lm.sft import LLMSFT
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import (SSLConfig,
                                                             Wav2Vec2Model)
    from unified_audio_tpu_torch.models.unise.model import (TASK_MAP, UniSE,
                                                            UniSEConfig)
    from unified_audio_tpu_torch.serve.engine import Request, segment_chunks
    return SimpleNamespace(**locals())


def build(run, p):
    """-> (reference, the port's UniSE): the reference's weights made from
    the seed and handed to the port's modules."""
    torch, cfg, dev = run.torch, run.config, run.device
    tup = run.reference._tuples
    p.cli._fp32_without_tf32()
    torch.manual_seed(run.seed % 2 ** 63)
    with torch.device(dev):
        ref = run.reference.UniSEReference(cfg)
    weights.fill_(torch, ref, run.generator(1))
    ref.eval().requires_grad_(False)
    lm_cfg = p.LlamaConfig(**cfg["lm"])
    with torch.device(dev):
        sft = p.LLMSFT(lm_cfg, num_tasks=len(p.TASK_MAP),
                       feats_dim=cfg["unise"]["feats_dim"])
        wavlm = p.Wav2Vec2Model(p.SSLConfig(**tup(cfg["wavlm"])))
        bicodec = p.BiCodec(p.BiCodecConfig(**tup(cfg["bicodec"])),
                            tokenize=False)
    for r, m in ((ref.lm, sft), (ref.wavlm, wavlm), (ref.bicodec, bicodec)):
        weights.hand_over(r, m)
        m.eval().requires_grad_(False)
    unise = p.UniSE(p.UniSEConfig(**cfg["unise"], llm=lm_cfg),
                    p.BiCodecTokenizer(bicodec, None), wavlm, sft)
    sft.to(getattr(torch, cfg["dtypes"]["lm_served"]))
    return ref, unise


class Traffic:
    """The cell's utterances: audio from banks made on the card from the
    seed, requests with the cell's sampling, uids counted up."""

    def __init__(self, run, p, unise):
        torch, t = run.torch, run.cell["traffic"]
        self.p, self.t, self.unise = p, t, unise
        ucfg = run.config["unise"]
        self.sr = ucfg["sample_rate"]
        self.seg = int(ucfg["segment_seconds"] * self.sr)
        n_max = int(round(t["max_seconds"] * self.sr))
        gen = run.generator(100)
        self.mix = audio.synth(torch, gen, t["bank_clips"], n_max, self.sr,
                               run.device).cpu().numpy()
        self.enroll = audio.synth(torch, gen, t["bank_clips"], int(
            t["enroll_seconds"] * self.sr), self.sr, run.device).cpu().numpy()
        self.plan = closed_loop.utterance_plan(  # apart from the audio's
            run.seed * 7, t["block"], t["min_seconds"],
            t["max_seconds"], t["tasks"], t["greedy_share"])
        self.next_uid = 0
        self.prompt_len = {}
        g = run.config["unise"]["global_tokens"]
        self.global_len, self.semantic_len = g, unise._semantic_len()

    def requests(self, utt):
        k = utt.index % len(self.mix)
        wav = np.roll(self.mix[k], utt.index * 7919)[:utt.n_samples]
        enroll = self.enroll[k] if utt.task != "se" else None
        out = []
        for seg in closed_loop.segments(wav, self.seg):
            uid, self.next_uid = self.next_uid, self.next_uid + 1
            out.append(self.p.Request(
                task_id=self.p.TASK_MAP[utt.task], mix_wav=seg,
                enroll_wav=enroll, global_length=self.global_len,
                semantic_length=self.semantic_len, uid=uid,
                temperature=self.t["temperature"], top_k=self.t["top_k"],
                top_p=self.t["top_p"], do_sample=not utt.greedy))
            frames = self.unise.wavlm_frames
            self.prompt_len[uid] = 2 + frames(len(seg)) + (
                0 if enroll is None else 1 + frames(len(enroll)))
        return out

    def steps(self, req) -> int:
        return req.global_length + 1 + req.semantic_length


class ServingLoop:
    """The closed loop over the engine, counting what the readers need in
    a traced run's window: the LM's operations of each prefill and step,
    the segments through WavLM and the detokenizer, and in the profiled
    wave K1's calls and their least time."""

    def __init__(self, run, st, traffic):
        self.run, self.st, self.tr = run, st, traffic
        self.in_window = self.profiling = False
        self.reqs = {}
        lm = run.config["lm"]
        self.lm = lm
        self.hd = lm["hidden_size"] // lm["num_heads"]
        self.vocab = 3 + lm["global_size"] + lm["semantic_size"]
        self.kv_bytes = run.torch.finfo(getattr(
            run.torch, run.config["dtypes"]["lm_served"])).bits // 8
        self.loop = closed_loop.ClosedLoop(
            run.cell["traffic"]["clients"], traffic.plan, traffic.sr,
            self._requests, self._finish, traffic.steps)

    def _counting(self) -> bool:
        return self.run.trace and self.in_window

    def _requests(self, utt):
        out = self.tr.requests(utt)
        self.reqs.update((r.uid, r) for r in out)
        return out

    def _finish(self, utt):
        run = self.run
        span = run.span if self.in_window else _no_span
        with span("detokenize", segments=len(utt.requests)):
            _decode(self.st, utt)
        if self._counting():
            run.count("detok_segments", len(utt.requests))

    def on_admit(self, uids):
        if not self._counting():
            return
        d = self.lm["hidden_size"]
        feats = self.run.config["unise"]["feats_dim"]
        for uid in uids:
            req = self.reqs[uid]
            n = self.tr.prompt_len[uid]
            frames = n - 2 - (0 if req.enroll_wav is None else 1)
            self.run.count("wavlm_segments", 1 + (req.enroll_wav is not None))
            self.run.count("lm_flops_bf16", self.lm["num_layers"] * (
                n * 32 * d * d + 4 * d * n * (n + 1) // 2)
                + 2 * feats * d * frames)

    def on_chunk(self, n):
        if not self._counting():
            return
        run, lm = self.run, self.lm
        layers = lm["num_layers"]
        live = [self.tr.prompt_len[uid] + done
                for uid, (_, done) in self.loop.live.items()]
        flops = 0
        for k in range(n):
            ctxs = [d + k + 1 for d in live]
            flops += sum(counts.lm_token_flops(lm["hidden_size"], layers,
                                               self.vocab, c) for c in ctxs)
            if self.profiling:
                moved, ops = counts.owner_call(
                    sum(ctxs), self.st.eng.num_slots, lm["num_heads"],
                    self.hd, self.kv_bytes)
                run.count("k1_least_s", layers * bound_s(moved, ops,
                                                         "bf16")[0])
                run.count("k1_calls", layers)
                run.count("profiled_steps", 1)
        run.count("lm_flops_bf16", flops)

    def turn(self):
        run, st = self.run, self.st
        span = run.span if self.in_window else _no_span
        closed_loop.cycle(st.eng, self.loop, st.gen, run.cell["poll_interval"],
                          st.p.segment_chunks, span, self.on_chunk,
                          self.on_admit)


@contextmanager
def _no_span(*args, **kwargs):
    yield


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
    traffic = Traffic(run, p, unise)
    # every utterance size's detokenize, then the loop's first waves: the
    # clients all start at once, and the window opens once the waves have
    # settled into their steady mix
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


def _decode(st, utt):
    g = np.stack([utt.outputs[r.uid].global_ids for r in utt.requests])
    s = np.stack([utt.outputs[r.uid].semantic_ids for r in utt.requests])
    utt.wav = st.unise._decode_tokens(g, s, utt.n_samples)


def window(run, st):
    srv = st.serving
    loop = srv.loop
    first = len(loop.completed)
    waves, marks = 0, []
    srv.in_window = True
    t0 = time.perf_counter()
    while True:
        srv.profiling = run.trace and waves == run.cell["traced_wave"]
        with (run.profiled() if srv.profiling else nullcontext()):
            srv.turn()
        srv.profiling = False
        waves += 1
        marks.append((time.perf_counter() - t0, len(loop.completed)))
        if marks[-1][0] >= run.seconds:
            break
    window_s = time.perf_counter() - t0
    srv.in_window = False
    done = loop.completed[first:]
    audio_s = sum(u.n_samples for u in done) / srv.tr.sr
    print(f"window: {waves} waves in {window_s:.3f} s, {len(done)} "
          f"utterances of {audio_s:.1f} s; wave ends (s, completed): "
          f"{[(round(a, 3), b - first) for a, b in marks]}",
          file=sys.stderr)
    run.records["window_s"] = window_s
    run.records["latencies"] = [u.latency for u in done]
    for r in loop.pending:
        st.eng.cancel(r.uid)
    return {"metrics": {"serve_audio_s_per_s": audio_s / window_s},
            "attempted": len(done), "failed": 0, "completed": done,
            "waves": waves, "window_s": window_s}


def release(run, st):
    st.eng = None
    st.unise = None
    st.serving = None
    gc.collect()
    if run.device != "cpu":
        run.torch.cuda.empty_cache()


def check(run, st, out, control: bool = False):
    """The compared numbers of a sample of the completed utterances drawn
    from the seed. ``control``: the reference in the program's place, one
    precision down (the LM in fp8 putting its own code first, or drawing
    its own code from its own support, at each position of the same
    prompts and codes; BiCodec's decoder with TF32 on), read against the
    fp32 reference alike."""
    torch, dev = run.torch, run.device
    c = run.cell["check"]
    lm = run.config["lm"]
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

    gap, n_tokens = 0.0, 0
    with torch.no_grad():
        for utt in sample([u for u in done if u.greedy],
                          c["greedy_utterances"]):
            for req in utt.requests:
                res = utt.outputs[req.uid]
                logits = _logits(torch, ref, req, res, dev)
                pick = None
                if control:
                    ref.lm.set_precision("fp8")
                    pick = _logits(torch, ref, req, res, dev)
                    ref.lm.set_precision("fp32")
                g = run.reference.gaps(*logits,
                                       _t(torch, res.global_ids, dev),
                                       _t(torch, res.semantic_ids, dev), lm,
                                       pick=pick)
                gap = max(gap, float(g.max()))
                n_tokens += g.numel()
        if n_tokens < c["min_tokens"]:
            gap = float("inf")  # too few greedy codes to judge
        support, n_sampled = 0.0, 0
        draw = torch.Generator(device=dev).manual_seed(run.seed % 2 ** 63)
        for utt in sample([u for u in done if not u.greedy],
                          c["sampled_utterances"]):
            for req in utt.requests:
                res = utt.outputs[req.uid]
                logits = _logits(torch, ref, req, res, dev)
                pick = None
                if control:
                    ref.lm.set_precision("fp8")
                    pick = (*_logits(torch, ref, req, res, dev),
                            req.temperature, draw)
                    ref.lm.set_precision("fp32")
                g = run.reference.support_gaps(
                    *logits, _t(torch, res.global_ids, dev),
                    _t(torch, res.semantic_ids, dev), lm, req.top_k,
                    req.top_p, pick=pick)
                support = max(support, float(g.max()))
                n_sampled += g.numel()
        if n_sampled < c["min_tokens"]:
            support = float("inf")  # too few sampled codes to judge
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
            _count_fp32(run, ref)
    run.records["tokens_compared"] = n_tokens + n_sampled
    return [{"name": "logit_gap", "value": gap, "limit": c["logit_gap"]},
            {"name": "support_gap", "value": support,
             "limit": c["support_gap"]},
            {"name": "waveform_rel_err", "value": err,
             "limit": c["waveform_rel_err"]}]


def _t(torch, a, dev):
    return torch.as_tensor(np.asarray(a), device=dev)


def _logits(torch, ref, req, res, dev):
    enroll = (None if req.enroll_wav is None
              else _t(torch, req.enroll_wav, dev).float())
    return ref.code_logits(req.task_id, _t(torch, req.mix_wav, dev).float(),
                           enroll, _t(torch, res.global_ids, dev),
                           _t(torch, res.semantic_ids, dev))


def _count_fp32(run, ref):
    """Model operations of the fp32 parts of the window: WavLM per
    segment, BiCodec's decoder per segment, from the reference's modules
    at the cell's sizes."""
    torch, dev = run.torch, run.device
    ucfg = run.config["unise"]
    seg = int(ucfg["segment_seconds"] * ucfg["sample_rate"])
    wav = torch.zeros(1, seg, device=dev)
    f_w = counts.count_flops(torch, [ref.wavlm], lambda: ref.features(wav))
    t = -(-seg // ucfg["hop_length"])
    g = torch.zeros(1, ucfg["global_tokens"], dtype=torch.long, device=dev)
    s = torch.zeros(1, t, dtype=torch.long, device=dev)
    f_d = counts.count_flops(torch, [ref.bicodec],
                             lambda: ref.detokenize(g, s))
    c = run.records["counts"]
    run.count("fp32_flops", c.get("wavlm_segments", 0) * f_w
              + c.get("detok_segments", 0) * f_d)
