"""Command-line entry points of the port: ``train-unise``, ``train-codec``,
``serve`` and ``codec``.

    python -m unified_audio_tpu_torch.cli train-unise \
        --config configs/unise.yaml [--ckpt LM.pt] [--bicodec-ckpt SD.pt] \
        [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli train-codec \
        --config configs/hcodec10.yaml [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli serve --requests R.jsonl \
        [--kv-quant int8] [--slots 16] [--ckpt LM.pt] [--seed 0] \
        [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli codec --model hcodec10|hcodec20 \
        --input X.wav --output Y.wav [--ckpt SD.pt] [--seed 0] \
        [--device cuda|cpu]

``train-unise`` ports ``cmd_train_unise`` in ``unified_audio_tpu/cli.py``:
UniSE's SFT training of the LM at full width (512 x 12, 8 heads of 64),
its data from the SCP lists of the config's ``dataset`` (simulated on the
host). Each step tokenizes the target with the frozen BiCodec over
XLSR-53 features (the interferer for "rtse"), extracts the frozen
WavLM-base-plus features of the mix and the enrollment, and takes one
clipped AdamW step on the teacher-forced LM loss under the reference
schedule (the config's ``opt``). Every ``log_every`` steps a record goes to
``metrics.jsonl`` in ``ckpt_dir`` (or the config's ``metrics_log``), every
``val_every`` steps ``val_batches`` batches of the ``val_dataset`` are
scored and a checkpoint written, and also every ``save_every`` steps; a
run over ``max_epochs`` epochs resumes from the latest checkpoint in
``ckpt_dir``, the optimizer's moments and the schedule included. A
checkpoint's ``state_dict`` is the LM in the reference layout, what
``serve --ckpt`` loads. ``--ckpt`` starts from an LM state dict;
``--bicodec-ckpt`` loads BiCodec from a state dict in the reference layout
(what ``export_bicodec_state_dict`` writes); XLSR-53 and WavLM are random
from the seed.

``train-codec`` ports ``cmd_train_codec``: HCodec's GAN training (the
config's ``model``, ``hcodec10`` or ``hcodec20``, at its ``codec`` widths)
against the MPD + MS-STFT discriminators, ``batch_size`` segments of
``segment_samples`` a step from the config's ``dataset`` (the
``DomainWeightedIterator`` arguments: ``domain_scps`` and the rest; it
must be there). The semantic targets are the frozen HuBERT-base's features
(the config's ``ssl`` section sets another size) of the 16 kHz (re)sample,
edge-padded or trimmed to ``segment_samples * 50 / sample_rate`` frames.
Every ``log_every`` steps a record goes to ``metrics.jsonl`` in
``ckpt_dir`` (or the config's ``metrics_log``), and every ``save_every``
steps and at the end a checkpoint holds the generator ("gen", which
``codec --ckpt`` loads), the discriminator ("disc") and the step. The
codec, the discriminators and HuBERT are random from the config's
``seed``, as in the JAX CLI. A run does not resume.

``serve`` ports ``cmd_serve`` in ``unified_audio_tpu/cli.py``: a JSONL
request file streams through the paged-KV engine. Each line: {"uid": int,
"task": "se"|"tse"|"rtse"|"ss", "mix": "path.wav", "enroll": "path.wav"
(tse/rtse), "output": "out.wav", "temperature"/"top_k"/"top_p"/"do_sample"
optional}. An "ss" line runs the separation cascade (``serve/cascade.py``):
its SE phase rides the first engine run with the other lines, and it writes
``<output stem>_s1.wav`` and ``<output stem>_s2.wav``. The stack runs at
full UniSE width: the LM in bf16, the WavLM frontend and the BiCodec decoder
in fp32. Weights are random unless ``--ckpt`` gives an LM state dict.

``codec`` ports ``cmd_codec`` for ``--model hcodec10`` (16 kHz, 25 Hz
codes) and ``hcodec20`` (48 kHz, 12.5 Hz codes): the wav goes through the
tokenize -> detokenize round trip at full width in fp32 (HuBERT-base
frontend), and the command prints the JAX package's JSON line, its
``tokens_per_sec`` the codes per second of audio of one quantizer layer.
Weights are random from ``--seed`` unless ``--ckpt`` gives a codec state
dict in the layout of ``utils/convert.py hcodec10_state_dict`` or
``hcodec20_state_dict``, weight norm folded or as ``weight_g``/``weight_v``,
or a checkpoint ``train-codec`` wrote.

Input wavs at another rate are resampled to the model's (16 kHz for
``serve`` and hcodec10, 48 kHz for hcodec20) on the device, and the command
says so on stderr.

All four run on the CUDA card and exit with an error without one, unless
``--device cpu`` asks for the CPU. fp32 means fp32 on the card: TF32 is off
for matmuls and for cuDNN (convolutions and the LSTMs), training included.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .data.audio_io import read_wav, write_wav

TARGET_SR = 16000  # UniSE operates on 16 kHz mono
TASK_MAP = {"se": 0, "tse": 1, "rtse": 2}
SS_UID = 10_000_000  # uid of the first cascade (regular lines count from 0)
WEIGHT_SEED = 3407  # random weights (no checkpoint given)


def _fp32_without_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _device(name: str) -> str:
    """The device an entry point runs on: the card unless the caller asked
    for the CPU. No silent fallback."""
    if name == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available; this command runs on "
                 "an NVIDIA card. Pass --device cpu to run it on the CPU.")
    return name


def load_lm(sft, ckpt, device="cpu"):
    """Load an LM state dict in the reference layout into ``sft``: a raw
    state dict, a checkpoint that holds one under "state_dict" (what
    ``train-unise`` writes), keys prefixed "dnn." or not."""
    blob = torch.load(ckpt, map_location=device, weights_only=True)
    sd = blob.get("state_dict", blob)
    sft.load_state_dict({k.replace("dnn.", ""): v for k, v in sd.items()})
    print(f"loaded LM state dict {ckpt}", file=sys.stderr)


def load_bicodec(bicodec, path, device="cpu"):
    """Load a BiCodec state dict in the reference layout (what
    ``export_bicodec_state_dict`` writes; the postnet and the codebook's
    usage statistics, which the port does not build, are dropped) into a
    tokenizing ``bicodec``."""
    from .utils.convert import bicodec_tokenizer_keys

    blob = torch.load(path, map_location=device, weights_only=True)
    bicodec.load_state_dict(bicodec_tokenizer_keys(
        blob.get("state_dict", blob)))
    print(f"loaded BiCodec state dict {path} (XLSR-53 and WavLM stay "
          "random)", file=sys.stderr)


def _build_unise(ckpt=None, device="cpu", tokenize=False, bicodec_ckpt=None,
                 seed=WEIGHT_SEED):
    """Full-size UniSE stack on ``device`` (all fp32; ``serve`` casts the
    LM). Random weights from ``seed`` through an explicit generator, with a
    loud warning, unless ``ckpt`` holds an LM state dict. ``tokenize``
    (training) also builds XLSR-53 and BiCodec's tokenize side, which
    serving does not; ``bicodec_ckpt`` then loads BiCodec from a state dict
    in the reference layout."""
    from .models.bicodec.bicodec import BiCodec, BiCodecConfig
    from .models.bicodec.tokenizer import BiCodecTokenizer
    from .models.lm.sft import LLMSFT
    from .models.ssl.wav2vec2 import (Wav2Vec2Model,
                                      wav2vec2_large_xlsr53_config,
                                      wavlm_base_plus_config)
    from .models.unise.model import UniSE, UniSEConfig
    from .utils.initialization import init_random_

    # fp32 means fp32: no TF32 in the frontend's and decoder's matmuls/convs
    _fp32_without_tf32()
    cfg = UniSEConfig()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        sft = LLMSFT(cfg.llm, num_tasks=len(TASK_MAP),
                     feats_dim=cfg.feats_dim)
        wavlm = Wav2Vec2Model(wavlm_base_plus_config())
        bicodec = BiCodec(BiCodecConfig(), tokenize=tokenize)
        xlsr = (Wav2Vec2Model(wav2vec2_large_xlsr53_config()) if tokenize
                else None)
    for module in (sft, wavlm, bicodec, xlsr):
        if module is not None:
            init_random_(module, gen).eval()
    if bicodec_ckpt:
        load_bicodec(bicodec, bicodec_ckpt, device)
    if ckpt:
        load_lm(sft, ckpt, device)
    else:
        print("WARNING: no --ckpt given: UniSE is RANDOMLY initialized and "
              "the output is not meaningful (smoke/benchmark use only)",
              file=sys.stderr)
    return UniSE(cfg, BiCodecTokenizer(bicodec, xlsr), wavlm, sft)


def _prepare_wav(wav: np.ndarray, fs: int, sr: int = TARGET_SR,
                 device="cpu") -> np.ndarray:
    """(channels, T) at ``fs`` -> (1, T') mono float32 at ``sr``, resampled
    on ``device``."""
    from .ops.dsp import resample

    if wav.ndim == 1:
        wav = wav[None]
    if wav.shape[0] > 1:
        wav = wav.mean(axis=0, keepdims=True)
    if fs != sr:
        wav = resample(torch.as_tensor(wav, dtype=torch.float32,
                                       device=device), fs, sr).cpu().numpy()
        print(f"resampled {fs} Hz -> {sr} Hz", file=sys.stderr)
    return wav.astype(np.float32)


def cmd_train_unise(args):
    """Train UniSE's LM as the config says (see the module docstring)."""
    from .data.data_module import Prefetcher, TrainDataIterator
    from .train.checkpoint import CheckpointManager
    from .train.optim import Optimizer
    from .train.sft_trainer import SFTTrainer, Validator
    from .utils.config import load_yaml
    from .utils.logging import MetricsLogger

    for flag, path in (("--config", args.config), ("--ckpt", args.ckpt),
                       ("--bicodec-ckpt", args.bicodec_ckpt)):
        if path and not Path(path).exists():
            sys.exit(f"error: {flag} file not found: {path}")
    device = _device(args.device)
    cfg = load_yaml(args.config)
    unise = _build_unise(ckpt=args.ckpt, device=device, tokenize=True,
                         bicodec_ckpt=args.bicodec_ckpt,
                         seed=cfg.get("seed", WEIGHT_SEED))
    trainer = SFTTrainer(unise, Optimizer(unise.sft.parameters(),
                                          **cfg.get("opt", {})))
    ckpt_dir = cfg.get("ckpt_dir", "./checkpoints")
    ckpt = CheckpointManager(ckpt_dir)
    last = ckpt.latest_step()
    if last is not None:
        trainer.load_state_dict(ckpt.restore(last, map_location=device))
        print(f"resumed from step {last} at learning rate "
              f"{trainer.optimizer.lr:.9g}", file=sys.stderr)

    data = Prefetcher(TrainDataIterator(**cfg["dataset"]), device)
    val_iter = (TrainDataIterator(**cfg["val_dataset"])
                if "val_dataset" in cfg else None)
    validator = Validator(unise) if val_iter is not None else None
    val_every = cfg.get("val_every", 1000)
    val_batches = cfg.get("val_batches", 16)
    log_every = cfg.get("log_every", 10)
    save_every = cfg.get("save_every", 1000)
    log_path = cfg.get("metrics_log", str(Path(ckpt_dir) / "metrics.jsonl"))
    with MetricsLogger(log_path) as mlog:
        for epoch in range(cfg.get("max_epochs", 100)):
            for mode, enroll, mix, speech, interf, *_ in data:
                target = interf if mode == "rtse" else speech
                lr = trainer.optimizer.lr
                loss, acc = trainer.train_step(mode, enroll, mix, target)
                if trainer.step % log_every == 0:
                    mlog.log(trainer.step, epoch=epoch, task=mode,
                             loss=loss, acc=acc, lr=lr)
                if validator is not None and trainer.step % val_every == 0:
                    batches = itertools.islice(
                        iter(Prefetcher(val_iter, device)), val_batches)
                    mlog.log(trainer.step, **validator.run(batches))
                    ckpt.save(trainer.step, trainer.state_dict())
                elif trainer.step % save_every == 0:
                    ckpt.save(trainer.step, trainer.state_dict())
    return trainer


def cmd_train_codec(args):
    """Train HCodec as the config says (see the module docstring)."""
    from .data.data_module import Prefetcher
    from .data.hcodec_data import DomainWeightedIterator
    from .models.hcodec.codec import HCodec, hcodec10_config, hcodec20_config
    from .models.hcodec.tokenizer import SSL_RATE
    from .models.ssl.wav2vec2 import (SSLConfig, Wav2Vec2Model,
                                      hubert_base_config, hubert_features)
    from .ops.dsp import resample
    from .train.checkpoint import CheckpointManager
    from .train.codec_trainer import CodecGANTrainer, CodecTrainConfig
    from .train.discriminators import CodecDiscriminator
    from .utils.config import load_yaml
    from .utils.initialization import init_random_
    from .utils.logging import MetricsLogger

    if not Path(args.config).exists():
        sys.exit(f"error: --config file not found: {args.config}")
    device = _device(args.device)
    cfg = load_yaml(args.config) or {}
    model = cfg.get("model", "hcodec10")
    if model not in HCODEC_NAMES:
        sys.exit(f"error: unknown codec model {model!r}; choose from "
                 f"{list(HCODEC_NAMES)}")
    if "dataset" not in cfg:
        sys.exit("error: config needs a 'dataset' section "
                 "(data.hcodec_data.DomainWeightedIterator kwargs: "
                 "domain_scps, batch_size, cut_seconds, ...)")
    build = hcodec20_config if model == "hcodec20" else hcodec10_config
    codec_cfg = build(**cfg.get("codec", {}))
    sr = codec_cfg.sample_rate
    b, t = cfg.get("batch_size", 8), cfg.get("segment_samples", 48000)
    want_frames = t * 50 // sr  # 50 Hz SSL frames of the segment

    _fp32_without_tf32()
    seed = cfg.get("seed", 0)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        codec = HCodec(codec_cfg, trainable=True)
        disc = CodecDiscriminator()
        ssl = Wav2Vec2Model(SSLConfig(**cfg["ssl"]) if "ssl" in cfg
                            else hubert_base_config())
    for module in (codec, disc, ssl):
        init_random_(module, gen)
    ssl.eval().requires_grad_(False)
    for m in codec.modules():
        if isinstance(m, torch.nn.LSTM):
            m.flatten_parameters()  # one weight buffer for cuDNN
    print(f"WARNING: {HCODEC_NAMES[model]}, its discriminators and the "
          "HuBERT feature extractor are RANDOMLY initialized (the JAX CLI "
          "trains against a random HuBERT too)", file=sys.stderr)
    trainer = CodecGANTrainer(codec, CodecTrainConfig(**cfg.get("train", {})),
                              disc, torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def features(wav):
        """HuBERT features of the 16 kHz (re)sample, edge-padded or
        trimmed to ``want_frames``."""
        f = hubert_features(ssl(resample(wav, sr, SSL_RATE)))
        if f.shape[1] < want_frames:
            f = torch.cat([f, f[:, -1:].expand(
                -1, want_frames - f.shape[1], -1)], 1)
        return f[:, :want_frames]

    data = Prefetcher(DomainWeightedIterator(
        sample_rate=sr, batch_size=b, cut_seconds=t / sr, **cfg["dataset"]),
        device)
    ckpt_dir = cfg.get("ckpt_dir", "./codec_checkpoints")
    ckpt = CheckpointManager(ckpt_dir)
    log_every = cfg.get("log_every", 10)
    save_every = cfg.get("save_every", 1000)
    max_steps = cfg.get("max_steps", 1_000_000)
    log_path = cfg.get("metrics_log", str(Path(ckpt_dir) / "metrics.jsonl"))
    print("codec GAN training started", file=sys.stderr)
    with MetricsLogger(log_path) as mlog:
        for epoch in range(cfg.get("max_epochs", 100)):
            for wav, _ in data:
                metrics = trainer.train_step(wav, features(wav))
                if trainer.step % log_every == 0:
                    mlog.log(trainer.step, epoch=epoch,
                             **{k: round(v, 5) for k, v in metrics.items()})
                if trainer.step % save_every == 0:
                    ckpt.save(trainer.step, trainer.state_dict())
                if trainer.step >= max_steps:
                    break
            if trainer.step >= max_steps:
                break
    ckpt.save(trainer.step, trainer.state_dict())
    return trainer


def _read_requests(path):
    if not Path(path).exists():
        sys.exit(f"error: request file not found: {path}")
    lines = [json.loads(l) for l in Path(path).read_text().splitlines()
             if l.strip()]
    if not lines:
        sys.exit("error: no requests")
    for l in lines:
        task = l.get("task", "se")
        if task not in TASK_MAP and task != "ss":
            sys.exit(f"error: unknown task {task!r}")
        if not Path(l["mix"]).exists():
            sys.exit(f"error: mix wav not found: {l['mix']}")
        if task in ("tse", "rtse") and not l.get("enroll"):
            sys.exit(f"error: task {task} requires 'enroll'")
    return lines


def make_engine(unise, slots: int = 16, kv_quant=None, **engine_kw):
    """The serving engine over ``unise``'s LM (in its current dtype and
    device): one mix/enroll bucket of a 5-s segment's feature frames, WavLM
    run on the device at admission. ``engine_kw`` go to the engine (the
    attention mode, a shared ``pool_ref`` and ``allocator``)."""
    from .serve.engine import ContinuousBatchingEngine

    cfg = unise.config
    sem_len = unise._semantic_len()
    return ContinuousBatchingEngine(
        unise.sft, num_slots=slots, max_global=cfg.global_tokens,
        max_semantic=sem_len + 6, mix_buckets=(sem_len + 6,),
        kv_quant=kv_quant or None, feature_fn=unise.wavlm_feats,
        frames_fn=unise.wavlm_frames, **engine_kw)


def serve(requests_path, unise, slots: int = 16, kv_quant=None,
          seed: int = 0, lm_dtype=torch.bfloat16) -> dict:
    """Serve a JSONL request file with ``unise``'s LM cast to ``lm_dtype``;
    writes each line's output wav (an "ss" line's two) and returns the run
    summary."""
    from .serve.cascade import SSCascadeRunner
    from .serve.engine import Request

    t_start = time.perf_counter()
    lines = _read_requests(requests_path)
    unise.sft.to(lm_dtype)
    cfg = unise.config
    seg = cfg.segment_len
    sem_len = unise._semantic_len()
    eng = make_engine(unise, slots, kv_quant)
    runner = SSCascadeRunner(eng, unise)

    def sampling(l):
        return dict(temperature=l.get("temperature", 0.8),
                    top_k=l.get("top_k", 50), top_p=l.get("top_p", 0.95),
                    do_sample=l.get("do_sample", True))

    # one Request per 5-s segment, each line peak-normalized; the mix and
    # the enrollment (cut to one segment) ride as waveforms and the engine
    # runs the WavLM frontend on the device at admission. An "ss" line
    # becomes a cascade, its features made on the device up front.
    reqs, meta, cascades = [], {}, {}
    for l in lines:
        wav, fs = read_wav(l["mix"])
        wav = _prepare_wav(wav, fs, device=eng.device)
        if l.get("task", "se") == "ss":
            cascades[l["output"]] = runner.make(
                wav, uid=SS_UID + len(cascades), **sampling(l))
            continue
        segs, orig_len = unise._segment(wav)
        segs = segs / (np.abs(wav).max() or 1.0)
        enroll_wav = None
        if l.get("enroll"):
            e, efs = read_wav(l["enroll"])
            e = _prepare_wav(e, efs, device=eng.device)[:, :seg]
            enroll_wav = (e / (np.abs(e).max() or 1.0))[0]
        uids = []
        for i in range(segs.shape[0]):
            uid = len(reqs)
            reqs.append(Request(
                task_id=TASK_MAP[l.get("task", "se")], mix_wav=segs[i],
                enroll_wav=enroll_wav, global_length=cfg.global_tokens,
                semantic_length=sem_len, uid=uid, **sampling(l)))
            uids.append(uid)
        meta[l["output"]] = (uids, orig_len)

    gen = torch.Generator(device=eng.device).manual_seed(seed)
    t0 = time.perf_counter()
    if cascades:
        separated, results = runner.run(list(cascades.values()), gen,
                                        extra=reqs)
    else:
        results = eng.run(reqs, gen)
    engine_s = time.perf_counter() - t0

    for out_path, (uids, orig_len) in meta.items():
        g = np.stack([results[u].global_ids for u in uids])
        s = np.stack([results[u].semantic_ids for u in uids])
        write_wav(out_path, unise._decode_tokens(g, s, orig_len), TARGET_SR)
    outputs = list(meta)
    for out_path, r in cascades.items():
        out = Path(out_path)
        for name, wav in zip(("_s1", "_s2"),
                             runner.assemble(r, separated[r.uid])):
            outputs.append(str(out.with_name(out.stem + name + ".wav")))
            write_wav(outputs[-1], wav, TARGET_SR)
    summary = {"requests": len(lines),
               # engine requests: a cascade's SE, TSE and rTSE segments
               "segments": len(reqs) + sum(1 + 2 * len(r.seg_feats)
                                           for r in cascades.values()),
               "cascades": len(cascades), "outputs": outputs,
               "engine_stats": eng.stats(), "engine_s": engine_s,
               "wall_s": time.perf_counter() - t_start,
               "device": str(eng.device)}
    print(json.dumps(summary))
    return summary


def cmd_serve(args):
    _read_requests(args.requests)  # fail fast, before the model build
    unise = _build_unise(ckpt=args.ckpt, device=_device(args.device))
    return serve(args.requests, unise, slots=args.slots,
                 kv_quant=args.kv_quant, seed=args.seed)


HCODEC_NAMES = {"hcodec10": "HCodec-1.0", "hcodec20": "HCodec-2.0"}


def _build_hcodec(model: str = "hcodec10", ckpt=None, seed: int = 0,
                  device="cpu", cfg=None, ssl_cfg=None):
    """HCodec-1.0 or -2.0 (``model``; ``cfg`` defaults to its shipped
    config) with a HuBERT frontend (``ssl_cfg``, default HuBERT-base) on
    ``device``, fp32, TF32 off. Random weights from ``seed`` through an
    explicit generator, with a loud warning; ``ckpt`` replaces the codec's
    weights with a state dict in the layout of ``utils/convert.py``
    (``hcodec10_state_dict`` / ``hcodec20_state_dict``, or a training
    state dict, under "gen" in a ``train-codec`` checkpoint), loaded
    strictly after ``hcodec_inference_keys`` (the HuBERT frontend stays
    random)."""
    from .models.hcodec.codec import HCodec, hcodec10_config, hcodec20_config
    from .models.hcodec.tokenizer import HCodecTokenizer
    from .models.ssl.wav2vec2 import Wav2Vec2Model, hubert_base_config
    from .utils.convert import hcodec_inference_keys
    from .utils.initialization import init_random_

    _fp32_without_tf32()
    name = HCODEC_NAMES[model]
    cfg = cfg or (hcodec20_config() if model == "hcodec20"
                  else hcodec10_config())
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        codec = HCodec(cfg)
        ssl = Wav2Vec2Model(ssl_cfg or hubert_base_config())
    for module in (codec, ssl):
        init_random_(module, gen)
    if ckpt:
        # on the host: hcodec_inference_keys folds weight norm in numpy
        blob = torch.load(ckpt, map_location="cpu", weights_only=True)
        sd = blob.get("gen", blob.get("state_dict", blob))
        codec.load_state_dict({k: torch.as_tensor(v) for k, v in
                               hcodec_inference_keys(sd).items()})
        print(f"loaded {name} state dict {ckpt} (the HuBERT frontend "
              "stays random)", file=sys.stderr)
    else:
        print(f"WARNING: no --ckpt given: {name} and HuBERT are RANDOMLY "
              "initialized and the reconstruction is not meaningful "
              "(smoke/benchmark use only)", file=sys.stderr)
    return HCodecTokenizer(codec, ssl)


def cmd_codec(args):
    """tokenize -> detokenize one wav at the codec's rate; prints and
    returns the JSON line of the JAX package's ``cmd_codec``."""
    if not Path(args.input).exists():
        sys.exit(f"error: input file not found: {args.input}")
    if args.ckpt and not Path(args.ckpt).exists():
        sys.exit(f"error: checkpoint not found: {args.ckpt}")
    device = _device(args.device)
    tok = _build_hcodec(args.model, ckpt=args.ckpt, seed=args.seed,
                        device=device)
    sr = tok.config.sample_rate
    wav, fs = read_wav(args.input)
    wav = _prepare_wav(wav, fs, sr, device)
    acoustic, semantic = tok.tokenize(torch.as_tensor(wav, device=device))
    rec = tok.detokenize(acoustic, semantic)[0].cpu().numpy()
    write_wav(args.output, rec, sr)
    summary = {"model": args.model,
               # codes per second of audio per quantizer layer (25 Hz for
               # hcodec10, 12.5 Hz for hcodec20)
               "tokens_per_sec": round(acoustic.shape[-1]
                                       / (wav.shape[-1] / sr), 2),
               "acoustic_shape": list(acoustic.shape),
               "out": str(args.output)}
    print(json.dumps(summary))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(prog="unified_audio_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train-unise")
    tr.add_argument("--config", required=True,
                    help="YAML training config (configs/unise.yaml)")
    tr.add_argument("--ckpt", default=None,
                    help="initial LM weights: a state dict in the reference "
                         "layout, or a checkpoint this command wrote")
    tr.add_argument("--bicodec-ckpt", default=None,
                    help="BiCodec state dict (.pt) in the reference layout "
                         "(what export_bicodec_state_dict writes)")
    tr.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    tr.set_defaults(fn=cmd_train_unise)
    tc = sub.add_parser("train-codec")
    tc.add_argument("--config", required=True,
                    help="YAML training config (configs/hcodec10.yaml plus "
                         "a 'dataset' section)")
    tc.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    tc.set_defaults(fn=cmd_train_codec)
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
    t.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    t.set_defaults(fn=cmd_serve)
    c = sub.add_parser("codec")
    c.add_argument("--model", choices=list(HCODEC_NAMES),
                   default="hcodec10",
                   help="HCodec-1.0 (16 kHz) or HCodec-2.0 (48 kHz); "
                        "hcodec15 and flexicodec are not ported yet")
    c.add_argument("--input", required=True,
                   help="wav, resampled to the codec's rate if need be")
    c.add_argument("--output", required=True)
    c.add_argument("--ckpt", default=None,
                   help="codec state dict (.pt) in the layout that "
                        "utils/convert.py hcodec10_state_dict or "
                        "hcodec20_state_dict writes")
    c.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (no --ckpt)")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.set_defaults(fn=cmd_codec)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
