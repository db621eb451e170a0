"""HCodec round trips of back-to-back batches through the port's
``HCodecTokenizer``: ``tokenize`` of a batch of clips, ``detokenize`` of
its codes, the codes and the waveforms brought to the host, as a corpus
tokenizer (and its listening check) would. The window closes at the first
batch end after ``--seconds``; the rate is the audio of the batches done
over the window's time.

A traced run calls ``tokenize``'s pieces itself (the HuBERT features, the
codec's encode with its residual VQs, then the decoder) so that each can
be timed, and profiles a few batches.

Once the program's state is freed, two batches drawn from the seed among
those done are held to the plain reference: the share of codes that differ
from the reference's own tokenize of the same clips, and the worst
waveform's distance from the reference's decoding of the program's codes.
"""
from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np

from portbench.harness import audio, counts, weights
from portbench.harness.peaks import bound_s


def _port():
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.models.hcodec.codec import (HCodec,
                                                             HCodecConfig)
    from unified_audio_tpu_torch.models.hcodec.tokenizer import (
        HCodecTokenizer)
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import (SSLConfig,
                                                             Wav2Vec2Model)
    return SimpleNamespace(**locals())


def setup(run):
    p = _port()
    torch, cfg, dev = run.torch, run.config, run.device
    tup = run.reference._tuples
    p.cli._fp32_without_tf32()
    t = run.cell["traffic"]
    sr = cfg["hcodec"]["sample_rate"]
    n = int(round(t["clip_seconds"] * sr))
    bank = audio.synth(torch, run.generator(2), t["bank_batches"] * t["batch"],
                       n, sr, dev).view(t["bank_batches"], t["batch"], n)
    torch.manual_seed(run.seed % 2 ** 63)
    with torch.device(dev):
        ref = run.reference.HCodec10Reference(cfg)
    weights.fill_(torch, ref, run.generator(1))
    ref.eval().requires_grad_(False)
    _scale_codebooks(torch, ref, bank[0, :2])
    with torch.device(dev):
        codec = p.HCodec(p.HCodecConfig(**tup(cfg["hcodec"])))
        ssl = p.Wav2Vec2Model(p.SSLConfig(**tup(cfg["hubert"])))
    weights.hand_over(ref.codec, codec)
    weights.hand_over(ref.ssl, ssl)
    for m in (codec, ssl):
        m.eval().requires_grad_(False)
    tok = p.HCodecTokenizer(codec, ssl)
    if dev != "cpu":
        ref.to("cpu")  # back on the card for the check, after the window
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    st = SimpleNamespace(p=p, ref=ref, tok=tok, bank=bank, sr=sr)
    for _ in range(2):  # warm-up: the cell's one shape
        _roundtrip(run, st, bank[0], traced=False)
    return st


def _scale_codebooks(torch, ref, wav):
    """Unit-normal codebooks scaled to the spread of each stream's latents
    on two clips of the bank, so that random weights still spread the codes
    over the codebook (an unscaled codebook far from the latents gives one
    code to nearly every frame)."""
    with torch.no_grad():
        x = ref.pad(wav)
        lat = ref.codec.encode_latents(x[..., None], ref.features(x))
        for q, z in zip((ref.codec.quantizer, ref.codec.semantic_quantizer),
                        lat):
            for cb in q.codebooks():
                cb.mul_(z.float().std())


def _roundtrip(run, st, wav, traced: bool):
    """-> (acoustic codes, semantic codes, waveforms), on the host."""
    tok = st.tok
    if not traced:
        a, s = tok.tokenize(wav)
        out = tok.detokenize(a, s)
    else:
        torch = run.torch
        with torch.no_grad():
            padded = tok.pad_wav(wav)
            with run.span("hubert"):
                feat = tok.extract_features(padded)
            with run.span("encode"):
                a, s = tok.codec.encode(padded[..., None], feat)
                a, s = a.transpose(-1, -2), s.transpose(-1, -2)
            with run.span("decode"):
                out = tok.detokenize(a, s)
    return a.cpu(), s.cpu(), out.cpu()


def window(run, st):
    t = run.cell["traffic"]
    hc = run.config["hcodec"]
    nb = t["bank_batches"]
    lo, hi = run.cell["traced_batches"]
    rng = np.random.default_rng(run.seed % 2 ** 32 + 29)
    keep, k = [], run.cell["check"]["batches"]
    done = 0
    t0 = time.perf_counter()
    prof = None
    while True:
        if run.trace and done == lo:
            prof = run.profiled()
            prof.__enter__()
        wav = st.bank[done % nb]
        a, s, out = _roundtrip(run, st, wav, run.trace)
        if run.trace and lo <= done < hi:
            m = a.shape[0] * a.shape[-1]
            for nq in (a.shape[1], s.shape[1]):
                moved, ops = counts.vq_call(m, hc["codebook_size"],
                                            hc["latent_dim"], nq)
                run.count("k6_least_s", bound_s(moved, ops, "tf32")[0])
                run.count("k6_calls", 1)
        done += 1
        if prof is not None and done == hi:
            prof.__exit__(None, None, None)
            prof = None
        # a uniform sample of the batches done (reservoir), from the seed
        item = (done - 1, a, s, out)
        if len(keep) < k:
            keep.append(item)
        else:
            j = rng.integers(0, done)
            if j < k:
                keep[j] = item
        if time.perf_counter() - t0 >= run.seconds and prof is None:
            break
    window_s = time.perf_counter() - t0
    audio_s = done * t["batch"] * t["clip_seconds"]
    run.records["window_s"] = window_s
    run.count("batches", done)
    return {"metrics": {"roundtrip_audio_s_per_s": audio_s / window_s},
            "attempted": done * t["batch"], "failed": 0, "kept": keep}


def release(run, st):
    st.tok = None
    gc.collect()
    if run.device != "cpu":
        run.torch.cuda.empty_cache()


def check(run, st, out, control: bool = False):
    """The compared numbers of the batches kept. ``control``: the
    reference in the program's place with TF32 on (the step below fp32),
    its codes and its decoding of the program's codes read against the
    fp32 reference alike."""
    torch, dev = run.torch, run.device
    c = run.cell["check"]
    ref = st.ref.to(dev)
    nb = run.cell["traffic"]["bank_batches"]
    differ, total, err, distinct = 0, 0, 0.0, []

    def tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    tf32(False)
    with torch.no_grad():
        for i, a, s, wav in out["kept"]:
            x = st.bank[i % nb]
            if control:  # the control's codes and waveforms in the program's
                tf32(True)
                a, s = ref.tokenize(x)
                wav = ref.detokenize(a, s).cpu()
                a, s = a.cpu(), s.cpu()
                tf32(False)
            ra, rs = ref.tokenize(x)
            w = ref.detokenize(a.to(dev), s.to(dev)).double().cpu()
            differ += int((ra.cpu() != a).sum() + (rs.cpu() != s).sum())
            total += a.numel() + s.numel()
            distinct.append(len(set(a[:, 0].flatten().tolist())))
            num = (wav.double() - w).norm(dim=-1)
            den = w.norm(dim=-1).clamp(min=1e-30)
            err = max(err, float((num / den).max()))
        if run.trace and not control:
            x = st.bank[0]
            f = counts.count_flops(torch, [ref], lambda: ref.detokenize(
                *ref.tokenize(x)))
            run.count("fp32_flops", f * run.records["counts"]["batches"])
    print(f"distinct first-layer acoustic codes a kept batch: {distinct}",
          file=sys.stderr)
    return [{"name": "code_mismatch", "value": differ / max(total, 1),
             "limit": c["code_mismatch"]},
            {"name": "waveform_rel_err", "value": err,
             "limit": c["waveform_rel_err"]}]

