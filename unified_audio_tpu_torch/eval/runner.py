"""Directory evaluation runner.

Port of ``unified_audio_tpu/eval/runner.py``: walks a test directory
(optionally with parallel clean and enrollment directories of the same
file names), runs the task flow (se / tse / ss) through UniSE's offline
``enhance_se`` / ``enhance_tse`` / ``separate_ss`` on the model's device,
writes the enhanced wavs if asked, and averages the objective metrics
(``eval/metrics.py``) over the utterances that have a reference. Each
utterance draws from its own ``torch.Generator``, seeded from the run's
seed (greedy decoding draws nothing). Inputs are not resampled, as in the
JAX package. ``roundtrip_codec_eval`` scores a codec's tokenize ->
detokenize round trip (HCodec's through K6 on the card).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data.audio_io import read_wav, write_wav
from . import metrics as M

ENROLL_S = 5.0  # enrollments are wrap-padded or cut to this length


@dataclass
class EvalConfig:
    mode: str = "se"  # se | tse | ss
    data_src_dir: str = ""
    data_tgt_dir: Optional[str] = None
    data_enroll_dir: Optional[str] = None
    save_enhanced: Optional[str] = None
    limit: Optional[int] = None


def iter_test_dir(cfg: EvalConfig):
    """Yield (name, src (1,T), tgt or None, enroll or None, fs)."""
    src_dir = Path(cfg.data_src_dir)
    files = sorted(src_dir.glob("*.wav"))
    if cfg.limit:
        files = files[: cfg.limit]
    for f in files:
        src, fs = read_wav(f)
        tgt = None
        if cfg.data_tgt_dir:
            tp = Path(cfg.data_tgt_dir) / f.name
            if tp.exists():
                tgt, _ = read_wav(tp)
        enroll = None
        if cfg.data_enroll_dir:
            ep = Path(cfg.data_enroll_dir) / f.name
            if ep.exists():
                enroll, _ = read_wav(ep)
                n = int(ENROLL_S * fs)
                if enroll.shape[-1] < n:
                    enroll = np.pad(enroll, [(0, 0), (0, n - enroll.shape[-1])],
                                    mode="wrap")
                enroll = enroll[:, :n]
        yield f.stem, src[:1], tgt[:1] if tgt is not None else None, enroll, fs


def evaluate(unise, cfg: EvalConfig, seed: int = 0,
             spk_embed_fn=None, utmos_predictor=None) -> Dict[str, float]:
    """Run the task flow over the directory; -> aggregated metrics.

    ``spk_embed_fn`` (wav (1,T) -> embedding, e.g. metrics.make_spk_embed_fn)
    adds the SPK-SIM column of the H-Codec results table.
    ``utmos_predictor`` (eval/utmos.UTMOSPredictor with converted weights)
    switches the MOS column from the proxy to learned UTMOS; the emitted
    key names the variant that produced it."""
    import torch

    device = next(unise.sft.parameters()).device
    seeds = np.random.SeedSequence(seed)
    save_dir = Path(cfg.save_enhanced) if cfg.save_enhanced else None
    if save_dir:
        save_dir.mkdir(parents=True, exist_ok=True)

    per_utt: List[Dict[str, float]] = []
    for name, src, tgt, enroll, fs in iter_test_dir(cfg):
        sub = torch.Generator(device=device).manual_seed(
            int(seeds.spawn(1)[0].generate_state(1)[0]))
        if cfg.mode == "se":
            est = unise.enhance_se(src, sub)
            outs = {name: est}
        elif cfg.mode == "tse":
            est = unise.enhance_tse(src, enroll, sub)
            outs = {name: est}
        else:  # ss: write s1/s2 (model.py:275-290)
            s1, s2 = unise.separate_ss(src, sub)
            outs = {f"{name}_s1": s1, f"{name}_s2": s2}
        for key, est in outs.items():
            if save_dir is not None:
                write_wav(save_dir / f"{key}.wav", est, fs)
        if tgt is not None and cfg.mode in ("se", "tse"):
            ref = tgt[0][: len(est)]
            # enhancement output is synthesized on the reference's own frame
            # grid (zero lag by construction) — skip the P.862 alignment
            # search, which can otherwise lock onto a pitch-period lag on
            # heavily distorted voiced content
            raw_pesq = M.pesq(est[: len(ref)], ref, fs, assume_aligned=True)
            mos, mos_variant = M.utmos(est, fs, predictor=utmos_predictor)
            utt = {
                "stoi": M.stoi(est[: len(ref)], ref, fs),
                "pesq": raw_pesq,
                "pesq_mos_lqo": M.pesq_mos_lqo(raw_pesq),
                mos_variant: mos,
                "si_snr": M.si_snr(est[: len(ref)], ref),
                "lsd": M.lsd(est[: len(ref)], ref),
            }
            if spk_embed_fn is not None:
                utt["spk_sim"] = M.spk_sim(
                    spk_embed_fn(est[None, : len(ref)]),
                    spk_embed_fn(ref[None]),
                )
            per_utt.append(utt)

    summary: Dict[str, float] = {"num_utts": float(len(per_utt))}
    if per_utt:
        for k in per_utt[0]:
            summary[k] = float(np.mean([u[k] for u in per_utt]))
    return summary


def roundtrip_codec_eval(tokenizer, wav_paths) -> Dict[str, float]:
    """Codec reconstruction benchmark (the H-Codec table 2 protocol:
    tokenize -> detokenize, score vs the original at each file's own rate)."""
    import torch

    device = next(tokenizer.codec.parameters()).device
    stats: List[Dict[str, float]] = []
    for p in wav_paths:
        wav, fs = read_wav(p)
        x = torch.as_tensor(wav[:1], device=device)
        g, s = tokenizer.tokenize(x)
        rec = tokenizer.detokenize(g, s)[0].cpu().numpy()
        ref = wav[0][: len(rec)]
        # codec round trips are sample-aligned by construction
        raw_pesq = M.pesq(rec[: len(ref)], ref, fs, assume_aligned=True)
        stats.append({
            "stoi": M.stoi(rec[: len(ref)], ref, fs),
            "pesq": raw_pesq,
            "pesq_mos_lqo": M.pesq_mos_lqo(raw_pesq),
            "utmos_proxy": M.utmos_proxy(rec, fs),
            "si_snr": M.si_snr(rec[: len(ref)], ref),
            "mcd": M.mcd(rec[: len(ref)], ref, fs),
        })
    return {k: float(np.mean([s[k] for s in stats])) for k in stats[0]}
