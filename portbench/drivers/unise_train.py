"""UniSE SFT training as ``cli train-unise`` runs it: the config's dataset
and optimizer sections, ``TrainDataIterator`` (host threads simulating
mixtures from SCP lists) -> ``Prefetcher`` (pinned, side stream) ->
``SFTTrainer.train_step`` (the frozen tokenize and features, the LM's
teacher-forced loss and backward, clipped AdamW under the warmup and
decay schedule), fp32 with TF32 off. No checkpoint is written. The
schedule is resumed at the cell's ``schedule_start`` (its peak, where a
run spends its time once the warmup is over), with fresh moments.

Set-up writes a synthetic speech, noise and RIR corpus from the seed under
the run's temporary directory, builds the trainer on the benchmark's
weights and drives it through its first steps, through the window's own
call and feed, until every task's shapes have run; the window goes on with
the same trainer and feed and closes at the first step end after
``--seconds``. A traced run calls ``train_step``'s pieces itself, in its
order, so that each can be timed.

The reference follows the first three steps from the same weights on the
same batches (the feed's output: its host simulation is the program's
and is not recomputed): the BiCodec tokens of the targets, each step's
loss, the first gradient as the optimizer got it (its first moment after
one step over 1 - beta1), and each parameter's change after the three
updates, leaf by leaf.
"""
from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
import wave
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench.harness import audio, counts, weights

BETA1 = 0.9


def _port():
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.data.data_module import (Prefetcher,
                                                          TrainDataIterator)
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
    from unified_audio_tpu_torch.train.optim import Optimizer
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer, _to
    return SimpleNamespace(**locals())


def build(run, p):
    torch, cfg, dev = run.torch, run.config, run.device
    tup = run.reference._tuples
    p.cli._fp32_without_tf32()
    torch.manual_seed(run.seed % 2 ** 63)
    with torch.device(dev):
        ref = run.reference.UniSEReference(cfg, tokenize=True)
    weights.fill_(torch, ref, run.generator(1))
    ref.eval().requires_grad_(False)
    lm_cfg = p.LlamaConfig(**cfg["lm"])
    with torch.device(dev):
        sft = p.LLMSFT(lm_cfg, num_tasks=len(p.TASK_MAP),
                       feats_dim=cfg["unise"]["feats_dim"])
        wavlm = p.Wav2Vec2Model(p.SSLConfig(**tup(cfg["wavlm"])))
        bicodec = p.BiCodec(p.BiCodecConfig(**tup(cfg["bicodec"])),
                            tokenize=True)
        xlsr = p.Wav2Vec2Model(p.SSLConfig(**tup(cfg["xlsr"])))
    for r, m in ((ref.lm, sft), (ref.wavlm, wavlm), (ref.bicodec, bicodec),
                 (ref.xlsr, xlsr)):
        weights.hand_over(r, m)
        m.eval()
    unise = p.UniSE(p.UniSEConfig(**cfg["unise"], llm=lm_cfg),
                    p.BiCodecTokenizer(bicodec, xlsr), wavlm, sft)
    return ref, unise


def _write_wav(path: Path, x: np.ndarray, sr: int) -> None:
    pcm = np.clip(np.rint(x * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_corpus(run, root: Path) -> dict:
    """Speech (speakers x utterances), noise and RIR files from the seed,
    made on the device in bulk; -> the dataset's SCP lists."""
    torch, c = run.torch, run.cell["corpus"]
    sr = run.config["unise"]["sample_rate"]
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    gen = run.generator(3)
    n_sp = c["speakers"] * c["utterances"]
    speech = audio.synth(torch, gen, n_sp, int(c["speech_seconds"] * sr),
                         sr, run.device).cpu().numpy() * 0.5
    noise = audio.synth(torch, gen, c["noises"], int(c["noise_seconds"] * sr),
                        sr, run.device)
    noise = (torch.randn(noise.shape, generator=gen, device=run.device)
             * 0.3).clamp(-1, 1).cpu().numpy()
    n_rir = int(c["rir_seconds"] * sr)
    decay = torch.exp(-torch.arange(n_rir, device=run.device) / (0.05 * sr))
    rir = torch.randn(c["rirs"], n_rir, generator=gen, device=run.device)
    rir = (rir * decay).cpu().numpy()
    rir[:, 0] = 1.0
    rir = 0.9 * rir / np.abs(rir).max(axis=1, keepdims=True)
    lines = {"speech": [], "noise": [], "rir": []}
    for i, x in enumerate(speech):
        spk = i // c["utterances"]
        path = root / f"s{i}.wav"
        _write_wav(path, x, sr)
        lines["speech"].append(f"u{i} spk{spk} {path}")
    for i, x in enumerate(noise):
        path = root / f"n{i}.wav"
        _write_wav(path, x, sr)
        lines["noise"].append(f"n{i} {sr} 0 {len(x)} {path}")
    for i, x in enumerate(rir):
        path = root / f"r{i}.wav"
        _write_wav(path, x, sr)
        lines["rir"].append(f"r{i} {path}")
    scps = {}
    for k, v in lines.items():
        (root / f"{k}.scp").write_text("\n".join(v) + "\n")
        scps[f"{k}_scp"] = [str(root / f"{k}.scp")]
    return scps


def setup(run):
    p = _port()
    torch = run.torch
    ref, unise = build(run, p)
    root = Path(tempfile.gettempdir()) / "portbench-unise-train"
    scps = write_corpus(run, root)
    data = p.Prefetcher(p.TrainDataIterator(
        **scps, **run.cell["dataset"], seed=run.seed % 2 ** 31), run.device)
    opt = p.Optimizer(unise.sft.parameters(), **run.cell["opt"])
    resume_schedule(opt, run.cell["schedule_start"])
    trainer = p.SFTTrainer(unise, opt)
    st = SimpleNamespace(p=p, ref=ref, unise=unise, trainer=trainer,
                         feed=iter(data), corpus=root, first=[],
                         by_mode={})
    if run.device != "cpu":
        ref.to("cpu")  # back on the card for the check, after the window
        torch.cuda.empty_cache()
    # the first steps, through the window's own call and feed: the
    # reference follows the first three
    real = unise.frozen_inputs
    names = [n for n, q in unise.sft.named_parameters() if q.requires_grad]
    for k in range(run.cell["first_steps"]):
        mode, enroll, mix, target = _next(st)
        got = {}
        if k < 3:
            def frozen(*a, _got=got):
                out = real(*a)
                _got["tokens"] = (out[2].cpu(), out[3].cpu())
                return out
            unise.frozen_inputs = frozen
        loss, _ = trainer.train_step(mode, enroll, mix, target)
        unise.frozen_inputs = real
        if k < 3:
            st.first.append({"mode": mode, "loss": loss, **got,
                             "inputs": [None if x is None else x.cpu()
                                        for x in (enroll, mix, target)]})
        if k == 2:
            st.after_three = {n: q.detach().cpu().clone()
                              for n, q in zip(names, trainer.optimizer.params)}
        if k == 0:
            state = trainer.optimizer.adamw.state
            st.first_grad = {
                n: (state[q]["exp_avg"] / (1 - BETA1)).cpu()
                if q in state and "exp_avg" in state[q] else
                torch.zeros_like(q, device="cpu")
                for n, q in zip(names, trainer.optimizer.params)}
        if mode not in st.by_mode:  # one batch of each task, for the counts
            st.by_mode[mode] = [None if x is None else x.cpu()
                                for x in (enroll, mix, target)]
        if k >= 2 and set(st.by_mode) >= set(run.cell["modes"]):
            break
    if run.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    return st


def resume_schedule(opt, start: int) -> None:
    """The optimizer's schedule continued from update ``start``, through
    its own resume path (``load_state_dict``), with fresh moments: the
    rate of the first update is ``schedule(start)``."""
    sd = opt.state_dict()
    lr = opt.schedule(start)
    sd["schedule"].update(last_epoch=start, _last_lr=[lr])
    for group in sd["adamw"]["param_groups"]:
        group["lr"] = lr
    opt.load_state_dict(sd)


def _next(st):
    mode, enroll, mix, speech, interf, *_ = next(st.feed)
    return mode, enroll, mix, interf if mode == "rtse" else speech


def _traced_step(run, st):
    """``train_step``'s pieces, in its order, each in a span."""
    p, trainer, unise = st.p, st.trainer, st.unise
    with run.span("data_wait"):
        mode, enroll, mix, target = _next(st)
    dev = trainer.device()
    with run.span("frozen"):
        frozen = unise.frozen_inputs(*(p._to(x, dev)
                                       for x in (enroll, mix, target)))
    with run.span("lm_fwd_bwd"):
        loss, acc = trainer.loss_backward(mode, frozen)
    with run.span("optim"):
        trainer.update()
    float(loss)
    return mode


def window(run, st):
    c = run.cell
    lo, hi = c["traced_steps"]
    steps, modes = 0, []
    audio_s = c["dataset"]["batch_size"] * c["dataset"]["cut_duration"][0]
    prof = None
    t0 = time.perf_counter()
    while True:
        if run.trace and steps == lo:
            prof = run.profiled()
            prof.__enter__()
        if run.trace:
            modes.append(_traced_step(run, st))
        else:
            mode, enroll, mix, target = _next(st)
            st.trainer.train_step(mode, enroll, mix, target)
            modes.append(mode)
        steps += 1
        if prof is not None and steps == hi:
            prof.__exit__(None, None, None)
            prof = None
        if time.perf_counter() - t0 >= run.seconds and prof is None:
            break
    window_s = time.perf_counter() - t0
    run.records["window_s"] = window_s
    run.records["modes"] = modes
    run.count("steps", steps)
    return {"metrics": {"train_audio_s_per_s": steps * audio_s / window_s},
            "attempted": steps, "failed": 0}


def release(run, st):
    st.trainer = st.unise = st.feed = None
    gc.collect()
    shutil.rmtree(st.corpus, ignore_errors=True)
    if run.device != "cpu":
        run.torch.cuda.empty_cache()


def schedule(opt: dict, step: int) -> float:
    """The optimizer's rate of update ``step`` (from 0): the cosine warmup,
    then the exponential decay floored at ``min_factor`` of the peak, in
    fp32 (a copy of ``train/optim.py warmup_exp_decay_schedule``)."""
    t = np.float32(step)
    if t < opt["warmup_steps"]:
        f = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(
            math.pi) * (np.float32(1) - t / np.float32(opt["warmup_steps"]))))
    else:
        f = max(np.float32(opt["step_decay"]) ** (t - opt["warmup_steps"]),
                np.float32(opt["min_factor"]))
    return float(np.float32(opt["peak_lr"]) * np.float32(f))


def check(run, st, out, control: bool = False):
    """The first three steps against the reference. ``control``: the
    reference with TF32 on in the program's place (its tokens, losses and
    first gradient read against the fp32 reference alike)."""
    torch, dev = run.torch, run.device
    c = run.cell
    ref = st.ref.to(dev)
    task_ids = st.p.TASK_MAP

    def tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    start = c["schedule_start"]

    def follow(tf):
        """The reference's three steps -> (tokens, losses, first grads,
        each leaf's change after the three, each step's gradient norms)."""
        tf32(tf)
        lm = ref.lm
        with torch.no_grad():
            saved = {n: q.detach().clone() for n, q in lm.named_parameters()}
        params = [q for _, q in lm.named_parameters()]
        for q in params:
            q.requires_grad_(True)
        opt = torch.optim.AdamW(params, lr=1.0, betas=(BETA1, 0.999),
                                eps=1e-8, weight_decay=c["opt"].get(
                                    "weight_decay", 0.01))
        tokens, losses, grads, step_norms = [], [], None, []
        for k, step in enumerate(st.first):
            x = [None if v is None else v.to(dev) for v in step["inputs"]]
            with torch.no_grad():
                ef, mf, g, s = ref.frozen_inputs(*x)
            tokens.append((g.cpu(), s.cpu()))
            loss = ref.sft_loss(task_ids[step["mode"]], ef, mf, g, s)
            opt.zero_grad(set_to_none=False)
            loss.backward()
            for q in params:  # a leaf the loss did not reach takes a
                if q.grad is None:  # zero gradient, as in optax: AdamW
                    q.grad = torch.zeros_like(q)  # counts and decays it
            gl = [q.grad for q in params]
            norm = torch.sqrt(sum(v.double().square().sum() for v in gl))
            if norm >= c["opt"]["grad_clip"]:
                for v in gl:
                    v.mul_(c["opt"]["grad_clip"] / norm)
            if k == 0:
                grads = {n: v.detach().cpu().clone()
                         for (n, _), v in zip(lm.named_parameters(), gl)}
            step_norms.append({n: float(v.double().norm()) for (n, _), v
                               in zip(lm.named_parameters(), gl)})
            for grp in opt.param_groups:
                grp["lr"] = schedule(c["opt"], start + k)
            opt.step()
            losses.append(float(loss.detach()))
        with torch.no_grad():
            change = {n: (q - saved[n]).cpu()
                      for n, q in lm.named_parameters()}
            for n, q in lm.named_parameters():
                q.copy_(saved[n])
                q.requires_grad_(False)
        tf32(False)
        return tokens, losses, grads, change, step_norms

    r_tokens, r_losses, r_grads, r_change, r_norms = follow(False)
    if control:
        p_tokens, p_losses, p_grads, p_change, _ = follow(True)
    else:
        p_tokens = [s["tokens"] for s in st.first]
        p_losses = [s["loss"] for s in st.first]
        p_grads = st.first_grad
        p_change = {n: v - ref.lm.get_parameter(n).detach().cpu()
                    for n, v in st.after_three.items()}
    differ = total = 0
    for (pg, ps), (rg, rs) in zip(p_tokens, r_tokens):
        differ += int((pg != rg).sum() + (ps != rs).sum())
        total += pg.numel() + ps.numel()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses))
    # leaves the loss reaches: a gradient under a thousandth of the median
    # leaf's is nought to rounding, and Adam moves such a leaf by round-off
    reached = [{n for n, v in norms.items() if v >= c["check"][
        "zero_grad_share"] * float(np.median(list(norms.values())))}
        for norms in r_norms]
    gap = norm_gap(r_grads, p_grads, reached[0])
    change_gap = norm_gap(r_change, p_change, set().union(*reached))
    if run.trace and not control:
        _count(run, st, ref)
    print(f"first steps: tasks {[s['mode'] for s in st.first]}, losses "
          f"program {p_losses} reference {r_losses}", file=sys.stderr)
    return [{"name": "token_mismatch", "value": differ / max(total, 1),
             "limit": c["check"]["token_mismatch"]},
            {"name": "loss_rel_err", "value": loss_err,
             "limit": c["check"]["loss_rel_err"]},
            {"name": "grad_norm_gap", "value": gap,
             "limit": c["check"]["grad_norm_gap"]},
            {"name": "change_norm_gap", "value": change_gap,
             "limit": c["check"]["change_norm_gap"]}]


def norm_gap(ref: dict, got: dict, leaves: set) -> float:
    """The worst of ``leaves``' gaps between the program's norm and the
    reference's, each over the larger of that leaf's and the median leaf's
    reference norm."""
    norms = {n: float(v.double().norm()) for n, v in ref.items()}
    med = float(np.median(list(norms.values())))
    gap = 0.0
    for n, rn in norms.items():
        if n not in leaves:
            continue
        pn = float(got[n].double().norm())
        gap = max(gap, abs(pn - rn) / max(rn, med))
    return gap


def _count(run, st, ref):
    """Model operations of the window's steps, fp32: the frozen inputs
    (forward) and the LM's forward and backward (three forwards) of one
    batch of each task, counted on the reference's modules (a task that
    set-up did not see counts as the cheapest seen)."""
    torch, dev = run.torch, run.device
    per_mode = {}
    for mode, inputs in st.by_mode.items():
        x = [None if v is None else v.to(dev) for v in inputs]
        with torch.no_grad():
            frozen = []
            f = counts.count_flops(torch, [ref], lambda: frozen.append(
                ref.frozen_inputs(*x)))
            lm = counts.count_flops(torch, [ref.lm], lambda: ref.sft_loss(
                st.p.TASK_MAP[mode], *frozen[0]))
        per_mode[mode] = f + 3 * lm
    least = min(per_mode.values())
    run.count("fp32_flops", sum(per_mode.get(m, least)
                                for m in run.records["modes"]))
