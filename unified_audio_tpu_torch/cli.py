"""Command-line entry point of the port: the ``serve`` subcommand.

    python -m unified_audio_tpu_torch.cli serve --requests R.jsonl \
        [--kv-quant int8] [--slots 16] [--ckpt LM.pt] [--seed 0]

Port of ``cmd_serve`` in ``unified_audio_tpu/cli.py`` for the tasks se, tse
and rtse: a JSONL request file streams through the paged-KV engine. Each
line: {"uid": int, "task": "se"|"tse"|"rtse", "mix": "path.wav",
"enroll": "path.wav" (tse/rtse), "output": "out.wav",
"temperature"/"top_k"/"top_p"/"do_sample" optional}. The separation cascade
(task "ss") is not ported yet and is rejected.

The stack runs at full UniSE width on CUDA when a card is present (else on
the CPU): the LM in bf16, the WavLM frontend and the BiCodec decoder in
fp32, with TF32 off. Weights are random from ``--seed`` unless ``--ckpt``
gives an LM state dict.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the one module shared with the JAX package: numpy and the stdlib only
from unified_audio_tpu.data.audio_io import read_wav, write_wav

TARGET_SR = 16000  # UniSE operates on 16 kHz mono
TASK_MAP = {"se": 0, "tse": 1, "rtse": 2}
WEIGHT_SEED = 3407  # random weights (no checkpoint given)


def _build_unise(ckpt=None, device="cpu"):
    """Full-size UniSE stack on ``device`` (all fp32; ``serve`` casts the
    LM). Random weights from WEIGHT_SEED through an explicit generator, with
    a loud warning, unless ``ckpt`` holds an LM state dict."""
    from .models.bicodec.bicodec import BiCodec, BiCodecConfig
    from .models.bicodec.tokenizer import BiCodecTokenizer
    from .models.lm.sft import LLMSFT
    from .models.ssl.wav2vec2 import Wav2Vec2Model, wavlm_base_plus_config
    from .models.unise.model import UniSE, UniSEConfig
    from .utils.initialization import init_random_

    # fp32 means fp32: no TF32 in the frontend's and decoder's matmuls/convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = UniSEConfig()
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    with torch.device(device):
        sft = LLMSFT(cfg.llm, num_tasks=len(TASK_MAP),
                     feats_dim=cfg.feats_dim)
        wavlm = Wav2Vec2Model(wavlm_base_plus_config())
        bicodec = BiCodec(BiCodecConfig())
    for module in (sft, wavlm, bicodec):
        init_random_(module, gen).eval()
    if ckpt:
        blob = torch.load(ckpt, map_location=device, weights_only=True)
        sd = blob.get("state_dict", blob)
        sft.load_state_dict({k.replace("dnn.", ""): v for k, v in sd.items()})
        print(f"loaded LM state dict {ckpt}", file=sys.stderr)
    else:
        print("WARNING: no --ckpt given: UniSE is RANDOMLY initialized and "
              "the output is not meaningful (smoke/benchmark use only)",
              file=sys.stderr)
    return UniSE(cfg, BiCodecTokenizer(bicodec), wavlm, sft)


def _prepare_wav(wav: np.ndarray, fs: int) -> np.ndarray:
    """(channels, T) -> (1, T) mono float32 at 16 kHz."""
    if wav.ndim == 1:
        wav = wav[None]
    if wav.shape[0] > 1:
        wav = wav.mean(axis=0, keepdims=True)
    if fs != TARGET_SR:
        sys.exit(f"error: input is {fs} Hz; the port takes {TARGET_SR} Hz "
                 "audio (resampling is not ported yet)")
    return wav.astype(np.float32)


def _read_requests(path):
    if not Path(path).exists():
        sys.exit(f"error: request file not found: {path}")
    lines = [json.loads(l) for l in Path(path).read_text().splitlines()
             if l.strip()]
    if not lines:
        sys.exit("error: no requests")
    for l in lines:
        task = l.get("task", "se")
        if task == "ss":
            sys.exit("error: task 'ss' (the separation cascade) is not "
                     "ported to the PyTorch package yet; use se, tse or rtse")
        if task not in TASK_MAP:
            sys.exit(f"error: unknown task {task!r}")
        if not Path(l["mix"]).exists():
            sys.exit(f"error: mix wav not found: {l['mix']}")
        if task in ("tse", "rtse") and not l.get("enroll"):
            sys.exit(f"error: task {task} requires 'enroll'")
    return lines


def make_engine(unise, slots: int = 16, kv_quant=None):
    """The serving engine over ``unise``'s LM (in its current dtype and
    device): one mix/enroll bucket of a 5-s segment's feature frames, WavLM
    run on the device at admission."""
    from .serve.engine import ContinuousBatchingEngine

    cfg = unise.config
    sem_len = unise._semantic_len()
    return ContinuousBatchingEngine(
        unise.sft, num_slots=slots, max_global=cfg.global_tokens,
        max_semantic=sem_len + 6, mix_buckets=(sem_len + 6,),
        kv_quant=kv_quant or None, feature_fn=unise.wavlm_feats,
        frames_fn=unise.wavlm_frames)


def serve(requests_path, unise, slots: int = 16, kv_quant=None,
          seed: int = 0, lm_dtype=torch.bfloat16) -> dict:
    """Serve a JSONL request file with ``unise``'s LM cast to ``lm_dtype``;
    writes each line's output wav and returns the run summary."""
    from .serve.engine import Request

    t_start = time.perf_counter()
    lines = _read_requests(requests_path)
    unise.sft.to(lm_dtype)
    cfg = unise.config
    seg = cfg.segment_len
    sem_len = unise._semantic_len()

    # one Request per 5-s segment, each line peak-normalized; the mix and
    # the enrollment (cut to one segment) ride as waveforms and the engine
    # runs the WavLM frontend on the device at admission
    reqs, meta = [], {}
    for l in lines:
        wav, fs = read_wav(l["mix"])
        wav = _prepare_wav(wav, fs)
        segs, orig_len = unise._segment(wav)
        segs = segs / (np.abs(wav).max() or 1.0)
        enroll_wav = None
        if l.get("enroll"):
            e, efs = read_wav(l["enroll"])
            e = _prepare_wav(e, efs)[:, :seg]
            enroll_wav = (e / (np.abs(e).max() or 1.0))[0]
        uids = []
        for i in range(segs.shape[0]):
            uid = len(reqs)
            reqs.append(Request(
                task_id=TASK_MAP[l.get("task", "se")], mix_wav=segs[i],
                enroll_wav=enroll_wav, global_length=cfg.global_tokens,
                semantic_length=sem_len,
                temperature=l.get("temperature", 0.8),
                top_k=l.get("top_k", 50), top_p=l.get("top_p", 0.95),
                do_sample=l.get("do_sample", True), uid=uid))
            uids.append(uid)
        meta[l["output"]] = (uids, orig_len)

    eng = make_engine(unise, slots, kv_quant)
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    t0 = time.perf_counter()
    results = eng.run(reqs, gen)
    engine_s = time.perf_counter() - t0

    for out_path, (uids, orig_len) in meta.items():
        g = np.stack([results[u].global_ids for u in uids])
        s = np.stack([results[u].semantic_ids for u in uids])
        write_wav(out_path, unise._decode_tokens(g, s, orig_len), TARGET_SR)
    summary = {"requests": len(lines), "segments": len(reqs),
               "outputs": list(meta), "engine_stats": eng.stats(),
               "engine_s": engine_s,
               "wall_s": time.perf_counter() - t_start,
               "device": str(eng.device)}
    print(json.dumps(summary))
    return summary


def cmd_serve(args):
    _read_requests(args.requests)  # fail fast, before the model build
    device = "cuda" if torch.cuda.is_available() else "cpu"
    unise = _build_unise(ckpt=args.ckpt, device=device)
    return serve(args.requests, unise, slots=args.slots,
                 kv_quant=args.kv_quant, seed=args.seed)


def main(argv=None):
    p = argparse.ArgumentParser(prog="unified_audio_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("serve")
    t.add_argument("--requests", required=True,
                   help="JSONL request file (see the module docstring)")
    t.add_argument("--ckpt", default=None,
                   help="LM (LLM_SFT) state dict in the reference torch "
                        "layout, a .pt file as export_custom_llama_state_dict "
                        "writes; orbax checkpoint directories are not "
                        "supported")
    t.add_argument("--slots", type=int, default=16)
    t.add_argument("--kv-quant", choices=["", "int8"], default="",
                   help="int8 KV block pool (half the pool bytes)")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_serve)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
