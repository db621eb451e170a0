"""Command-line entry points of the port: ``train-unise``, ``train-codec``,
``serve``, ``enhance``, ``codec`` and ``eval``.

    python -m unified_audio_tpu_torch.cli train-unise \
        --config configs/unise.yaml [--ckpt LM.pt] [--bicodec-ckpt SD.pt] \
        [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli train-codec \
        --config configs/hcodec10.yaml [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli serve --requests R.jsonl \
        [--config configs/unise_moonlight16b.yaml] [--kv-quant int8] \
        [--slots 16] [--ckpt LM.pt] [--seed 0] [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli enhance --mode se|tse|ss \
        --input X.wav --output Y.wav [--enroll E.wav] [--ckpt LM.pt] \
        [--bicodec-ckpt SD.safetensors] [--sample] [--seed 0] \
        [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli codec \
        --model hcodec10|hcodec20|hcodec15|flexicodec \
        --input X.wav --output Y.wav [--ckpt SD.pt] [--seed 0] \
        [--dtype float32|bfloat16] [--cmvn am.mvn] \
        [--sensevoice-ckpt SV.pt] [--device cuda|cpu]
    python -m unified_audio_tpu_torch.cli eval --test-dir DIR \
        [--tgt-dir DIR] [--enroll-dir DIR] [--mode se|tse|ss] [--ckpt LM.pt] \
        [--bicodec-ckpt SD] [--spk-sim] [--utmos-ckpt U.pt] \
        [--save-enhanced DIR] [--max-items N] [--seed 0] [--device cuda|cpu]

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

Under ``torchrun`` (``torchrun --nproc_per_node N -m
unified_audio_tpu_torch.cli train-unise --config C.yaml``) every process
joins one NCCL group on ``cuda:LOCAL_RANK`` (gloo with ``--device cpu``)
and trains on the (dp, tp) mesh, ``tp`` from the config (JAX: the mesh
of ``cmd_train_unise`` whenever there is more than one device): the LM's
projections cut over tp, each dp rank on its own batches of the
dataset's ``batch_size`` (per rank), the gradients averaged over dp. Only
rank 0 logs and writes checkpoints, which hold the whole model in the
single-device layout, so a run resumes at another world size or tp.
Without ``torchrun`` the command runs on one device.

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
``--config`` names a YAML config whose ``lm`` section replaces the LM's
stack (``configs/unise_moonlight16b.yaml``: the Moonlight-16B-A3B
backbone, latent attention over a latent paged pool and routed experts,
built in bf16); ``train-unise`` reads the same section from its config.

``enhance`` ports ``cmd_enhance``: one wav through UniSE's offline
``enhance_se`` (se), ``enhance_tse`` with ``--enroll`` (tse) or the
``separate_ss`` cascade (ss, writing ``<stem>_s1.wav`` and
``<stem>_s2.wav``), greedy unless ``--sample`` (draws from a generator
seeded by ``--seed``), the LM in fp32. It prints "done", with " (random
weights)" without ``--ckpt``.

``eval`` ports ``cmd_eval``: UniSE over a directory of wavs
(``eval/runner.py``), scored against the clean references of ``--tgt-dir``;
SPK-SIM with ``--bicodec-ckpt`` or ``--spk-sim`` (BiCodec's speaker side is
then built, without XLSR-53), learned UTMOS with ``--utmos-ckpt``; one JSON
line of the averaged metrics.

``--ckpt`` takes a reference LM state dict, "dnn."-prefixed or not, raw or
under "state_dict" (a Lightning checkpoint's, or ``train-unise``'s): the
keys the JAX package's ``convert_custom_llama`` reads are loaded, a missing
one is an error, the others (the reference's bypassed conformer) are named
on stderr. ``--bicodec-ckpt`` takes a ``.pt`` or the reference's
``.safetensors`` file.

``codec`` ports ``cmd_codec``. For ``--model hcodec10`` (16 kHz, 25 Hz
codes) and ``hcodec20`` (48 kHz, 12.5 Hz codes) the wav goes through the
tokenize -> detokenize round trip at full width in fp32 (HuBERT-base
frontend), or with ``--dtype bfloat16`` in the bf16 serving mode
(``models/hcodec/tokenizer.py``), and the command prints the JAX package's
JSON line, its
``tokens_per_sec`` the codes per second of audio of one quantizer layer.
Weights are random from ``--seed`` unless ``--ckpt`` gives a codec state
dict in the layout of ``utils/convert.py hcodec10_state_dict`` or
``hcodec20_state_dict``, weight norm folded or as ``weight_g``/``weight_v``,
or a checkpoint ``train-codec`` wrote.

``codec --model hcodec15`` is HCodec-1.5 adaptive (``adaptive15_config``,
XLSR-53 frontend, random unless ``--ckpt`` gives the codec in the layout of
``export_hcodec15_state_dict``; XLSR-53 stays random): its codes are (1, 4,
G) group codes with the group lengths injected, ``tokens_per_sec`` the
realised group rate. ``codec --model flexicodec`` is FlexiCodec in the
DualCodec mode at 16 kHz (``--ckpt`` a ``.pt`` or ``.safetensors`` state
dict in the layout of ``export_flexicodec_state_dict``; its
``convnext_encoder.0`` width sets ``ssl_dim``). Its semantic stream is the
SAN-M teacher with ``--sensevoice-ckpt`` (a funasr SenseVoiceSmall state
dict; needs ``--cmvn``), the teacher's fbank + LFR + CMVN frontend with
``--cmvn`` alone, else a log-fbank fallback; it is resampled to twice the
acoustic frame count. Both run in fp32 only: ``--dtype bfloat16`` with them
is an error.

Input wavs at another rate are resampled to the model's (16 kHz for
``serve``, hcodec10, hcodec15 and flexicodec, 48 kHz for hcodec20) on the
device, and the command says so on stderr.

All six run on the CUDA card and exit with an error without one, unless
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


def _key_groups(keys) -> str:
    """Keys named by their first component: "conformer.* (12), postnet.*
    (4)"."""
    groups = {}
    for k in keys:
        head = k.split(".")[0]
        name = f"{head}.*" if "." in k else k
        groups[name] = groups.get(name, 0) + 1
    return ", ".join(f"{g} ({n})" for g, n in sorted(groups.items()))


def load_state(module, sd, what: str):
    """Load into ``module`` the entries of the state dict ``sd`` that it
    has, and no other. A key the module needs and ``sd`` lacks ends the
    command with an error; the keys it ignores are named on stderr."""
    have = set(module.state_dict())
    missing = module.load_state_dict(
        {k: v for k, v in sd.items() if k in have}, strict=False).missing_keys
    if missing:
        sys.exit(f"error: {what} lacks {len(missing)} key(s) the model "
                 f"needs: {', '.join(missing[:8])}"
                 f"{' ...' if len(missing) > 8 else ''}")
    ignored = [k for k in sd if k not in have]
    if ignored:
        print(f"{what}: ignored {len(ignored)} key(s) the model does not "
              f"use: {_key_groups(ignored)}", file=sys.stderr)


def _torch_state_dict(path, device="cpu"):
    """A raw state dict, or the one a checkpoint holds under "state_dict"
    (a Lightning checkpoint's, beside its epoch, step, hyper-parameters
    and optimizer states, or what ``train-unise`` writes). Read with
    ``weights_only=True``: tensors and plain Python types only."""
    blob = torch.load(path, map_location=device, weights_only=True)
    return blob.get("state_dict", blob)


def refuse_checkpoint_dir(ckpt):
    """Exit with an error when the LM checkpoint ``ckpt`` is a directory:
    the JAX package's orbax checkpoints are directories, which the port
    reads only once ``orbax_to_torch.py`` (run where JAX is installed) has
    converted them."""
    if ckpt and Path(ckpt).is_dir():
        sys.exit(f"error: --ckpt {ckpt} is a directory, not a torch file; "
                 "if it is an orbax checkpoint of the JAX package, convert "
                 "it where JAX and orbax are installed: python "
                 f"orbax_to_torch.py {ckpt} lm.pt [--step N], then pass "
                 "--ckpt lm.pt")


def load_lm(sft, ckpt, device="cpu"):
    """Load an LM state dict in the reference layout into ``sft``, keys
    prefixed "dnn." or not. It takes exactly the keys the JAX package's
    ``convert_custom_llama`` reads (the embeddings, the layers, the norm,
    the output head, the task and sos embeddings, the adapter); the
    reference's bypassed conformer (``conformer.*``) and any other key are
    ignored and named on stderr. A directory (an orbax checkpoint) ends
    the command with an error that names the converter."""
    refuse_checkpoint_dir(ckpt)
    sd = {k.replace("dnn.", ""): v
          for k, v in _torch_state_dict(ckpt, device).items()}
    load_state(sft, sd, f"LM state dict {ckpt}")
    print(f"loaded LM state dict {ckpt}", file=sys.stderr)


def _read_state_dict(path, device="cpu"):
    """A ``.safetensors`` file, or a torch state dict (raw or under
    "state_dict")."""
    if Path(path).suffix == ".safetensors":
        try:
            from safetensors.torch import load_file
        except ImportError:
            sys.exit(f"error: reading {path} needs the 'safetensors' "
                     "package, which is not installed")
        return load_file(str(path), device=str(device))
    return _torch_state_dict(path, device)


def load_bicodec(bicodec, path, device="cpu"):
    """Load a BiCodec state dict in the reference layout (what
    ``export_bicodec_state_dict`` writes, or the reference's
    ``.safetensors`` file) into ``bicodec``: the keys of the modules it
    builds (the decoder, and with ``tokenize`` the encoder and the speaker
    encoder); the postnet and the codebook's usage statistics, which the
    port does not build, are ignored."""
    load_state(bicodec, _read_state_dict(path, device),
               f"BiCodec state dict {path}")
    print(f"loaded BiCodec state dict {path} (XLSR-53 and WavLM stay "
          "random)", file=sys.stderr)


def _build_unise(ckpt=None, device="cpu", tokenize=False, bicodec_ckpt=None,
                 seed=WEIGHT_SEED, speaker=False, llm=None,
                 lm_dtype=torch.float32):
    """Full-size UniSE stack on ``device`` (all fp32; ``serve`` casts the
    LM). Random weights from ``seed`` through an explicit generator, with a
    loud warning, unless ``ckpt`` holds an LM state dict. ``tokenize``
    (training) also builds XLSR-53 and BiCodec's tokenize side, which
    serving does not; ``speaker`` (``eval``'s SPK-SIM) builds BiCodec's
    tokenize side, its mel and speaker encoder among it, without XLSR-53.
    ``bicodec_ckpt`` loads BiCodec from a state dict in the reference
    layout. ``llm`` (a config's ``lm`` section, ``lm_config``) replaces
    UniSE's LM stack, built and initialized in ``lm_dtype`` (a 15-B
    parameter stack held in fp32 would not leave room on the card)."""
    from .models.bicodec.bicodec import BiCodec, BiCodecConfig
    from .models.bicodec.tokenizer import BiCodecTokenizer
    from .models.lm.sft import build_sft
    from .models.ssl.wav2vec2 import (Wav2Vec2Model,
                                      wav2vec2_large_xlsr53_config,
                                      wavlm_base_plus_config)
    from .models.unise.model import UniSE, UniSEConfig
    from .utils.initialization import init_random_

    # fp32 means fp32: no TF32 in the frontend's and decoder's matmuls/convs
    _fp32_without_tf32()
    cfg = UniSEConfig() if llm is None else UniSEConfig(llm=llm)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        default = torch.get_default_dtype()
        torch.set_default_dtype(lm_dtype)
        try:
            sft = build_sft(cfg.llm, num_tasks=len(TASK_MAP),
                            feats_dim=cfg.feats_dim)
        finally:
            torch.set_default_dtype(default)
        wavlm = Wav2Vec2Model(wavlm_base_plus_config())
        bicodec = BiCodec(BiCodecConfig(), tokenize=tokenize or speaker)
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


def _torchrun_mesh(device: str, tp: int):
    """Under ``torchrun`` (its ``WORLD_SIZE`` in the environment): join the
    process group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
    cpu``; no fallback) and build the (dp, tp) mesh -> (mesh, this rank's
    device). Without ``torchrun``: (None, ``device``)."""
    import os

    if "WORLD_SIZE" not in os.environ:
        return None, device
    from .parallel import distributed
    from .parallel import mesh as mesh_lib

    try:
        distributed.initialize(device=device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"error: {e}")
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    try:
        mesh = mesh_lib.make_mesh(tp=tp)
    except ValueError as e:
        sys.exit(f"error: {e}")
    dist = torch.distributed
    if dist.get_rank() == 0:
        dp = mesh_lib.axis_size(mesh, "dp")
        print(f"torchrun: {dist.get_backend()} group of "
              f"{dist.get_world_size()} on the (dp {dp}, tp {tp}) mesh; "
              f"rank 0 on {device}", file=sys.stderr)
    return mesh, device


class _Quiet:
    """The logger of a rank other than 0: records nothing."""

    def log(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def cmd_train_unise(args):
    """Train UniSE's LM as the config says (see the module docstring)."""
    import torch.distributed as dist

    from .train.optim import Optimizer
    from .train.sft_trainer import SFTTrainer
    from .utils.config import load_yaml

    _require_files(("--config", args.config), ("--ckpt", args.ckpt),
                   ("--bicodec-ckpt", args.bicodec_ckpt))
    device = _device(args.device)
    cfg = load_yaml(args.config)
    mesh, device = _torchrun_mesh(device, cfg.get("tp", 1))
    rank = dist.get_rank() if mesh is not None else 0
    try:
        unise = _build_unise(ckpt=args.ckpt, device=device, tokenize=True,
                             bicodec_ckpt=args.bicodec_ckpt,
                             seed=cfg.get("seed", WEIGHT_SEED),
                             **_lm_section(args.config, torch.float32))
        trainer = SFTTrainer(unise, Optimizer(unise.sft.parameters(),
                                              **cfg.get("opt", {})),
                             mesh=mesh)
        _train_unise(trainer, cfg, device, mesh, rank)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    return trainer


def _train_unise(trainer, cfg, device, mesh, rank):
    """The training loop of ``cmd_train_unise``: rank 0 logs and writes
    the checkpoints (which every rank gathers)."""
    from .data.data_module import Prefetcher, TrainDataIterator
    from .parallel import mesh as mesh_lib
    from .train.checkpoint import CheckpointManager
    from .train.sft_trainer import Validator
    from .utils.logging import MetricsLogger

    ckpt_dir = cfg.get("ckpt_dir", "./checkpoints")
    ckpt = CheckpointManager(ckpt_dir)
    last = ckpt.latest_step()
    if last is not None:
        trainer.load_state_dict(ckpt.restore(last, map_location=device))
        if rank == 0:
            print(f"resumed from step {last} at learning rate "
                  f"{trainer.optimizer.lr:.9g}", file=sys.stderr)

    def save():
        state = trainer.state_dict()
        if rank == 0:
            ckpt.save(trainer.step, state)

    # each dp coordinate draws its own batches; its tp peers take the same
    shard = {}
    if mesh is not None:
        index, count = mesh_lib.dp_shard(mesh)
        shard = dict(process_index=index, process_count=count)
    data = Prefetcher(TrainDataIterator(**cfg["dataset"], **shard), device)
    val_iter = (TrainDataIterator(**cfg["val_dataset"], **shard)
                if "val_dataset" in cfg else None)
    validator = (Validator(trainer.unise, mesh) if val_iter is not None
                 else None)
    val_every = cfg.get("val_every", 1000)
    val_batches = cfg.get("val_batches", 16)
    log_every = cfg.get("log_every", 10)
    save_every = cfg.get("save_every", 1000)
    log_path = cfg.get("metrics_log", str(Path(ckpt_dir) / "metrics.jsonl"))
    with (MetricsLogger(log_path) if rank == 0 else _Quiet()) as mlog:
        for epoch in range(cfg.get("max_epochs", 100)):
            for mode, enroll, mix, speech, interf, *_ in \
                    mesh_lib.share_batches(data, mesh):
                target = interf if mode == "rtse" else speech
                lr = trainer.optimizer.lr
                loss, acc = trainer.train_step(mode, enroll, mix, target)
                if trainer.step % log_every == 0:
                    mlog.log(trainer.step, epoch=epoch, task=mode,
                             loss=loss, acc=acc, lr=lr)
                if validator is not None and trainer.step % val_every == 0:
                    batches = itertools.islice(mesh_lib.share_batches(
                        Prefetcher(val_iter, device), mesh), val_batches)
                    mlog.log(trainer.step, **validator.run(batches))
                    save()
                elif trainer.step % save_every == 0:
                    save()


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
    device), as the JAX ``serve`` builds it: one feature-frame bucket of a
    5-s segment (and the frames of one segment's samples), one sample
    bucket of a segment, WavLM run on the device at admission, waveforms on
    the int16 wire. ``engine_kw`` go to the engine (the attention mode, a
    shared ``pool_ref`` and ``allocator``, the wires)."""
    from .serve.engine import ContinuousBatchingEngine

    cfg = unise.config
    sem_len = unise._semantic_len()
    return ContinuousBatchingEngine(
        unise.sft, num_slots=slots, max_global=cfg.global_tokens,
        max_semantic=sem_len + 6, mix_buckets=(sem_len + 6,),
        kv_quant=kv_quant or None, feature_fn=unise.wavlm_feats,
        frames_fn=unise.wavlm_frames, wav_buckets=(cfg.segment_len,),
        **engine_kw)


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

    # one Request per 5-s segment, each line peak-normalized; the mix rides
    # as a waveform on the int16 wire and the engine runs the WavLM
    # frontend on the device at admission. The enrollment is cut to one
    # segment: a whole segment rides the wire too, a shorter one goes in as
    # exact-length features (WavLM's global attention would give other
    # features for audio padded to the bucket), as the JAX ``serve`` does.
    # An "ss" line becomes a cascade, its features made on the device up
    # front.
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
        enroll_wav = enroll_feats = None
        if l.get("enroll"):
            e, efs = read_wav(l["enroll"])
            e = _prepare_wav(e, efs, device=eng.device)[:, :seg]
            e = e / (np.abs(e).max() or 1.0)
            if e.shape[-1] == seg:
                enroll_wav = e[0]
            else:
                enroll_feats = unise.wavlm_feats(
                    torch.as_tensor(e, device=eng.device))[0]
        uids = []
        for i in range(segs.shape[0]):
            uid = len(reqs)
            reqs.append(Request(
                task_id=TASK_MAP[l.get("task", "se")], mix_wav=segs[i],
                enroll_wav=enroll_wav, enroll_feats=enroll_feats,
                global_length=cfg.global_tokens,
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


def _lm_section(config, lm_dtype):
    """``_build_unise``'s LM arguments from a YAML config's ``lm`` section
    (none without a config or a section: UniSE's own LM)."""
    from .models.unise.model import lm_config
    from .utils.config import load_yaml

    section = (load_yaml(config) or {}).get("lm") if config else None
    return {} if not section else {"llm": lm_config(section),
                                   "lm_dtype": lm_dtype}


def cmd_serve(args):
    _read_requests(args.requests)  # fail fast, before the model build
    _require_files(("--ckpt", args.ckpt), ("--config", args.config))
    unise = _build_unise(ckpt=args.ckpt, device=_device(args.device),
                         **_lm_section(args.config, torch.bfloat16))
    return serve(args.requests, unise, slots=args.slots,
                 kv_quant=args.kv_quant, seed=args.seed)


def _require_files(*pairs):
    """Exit with an error naming the flag of the first given path that does
    not exist; ``pairs`` are (flag, path or None)."""
    for flag, path in pairs:
        if path and not Path(path).exists():
            sys.exit(f"error: {flag} file not found: {path}")
        if flag == "--ckpt":
            refuse_checkpoint_dir(path)


def cmd_enhance(args):
    """Enhance (se), extract the enrolled speaker (tse) or separate two
    speakers (ss) of one wav offline, through UniSE's ``LLMSFT.generate``
    (greedy unless ``--sample``); "ss" writes ``<stem>_s1.wav`` and
    ``<stem>_s2.wav``. The LM runs fp32 (TF32 off), as the JAX package's
    ``cmd_enhance`` runs its converted fp32 parameters."""
    # validate the inputs before the model build, as the JAX CLI does
    _require_files(("--input", args.input))
    if args.mode == "tse" and not args.enroll:
        sys.exit("error: --mode tse requires --enroll <wav>")
    _require_files(("--enroll", args.enroll), ("--ckpt", args.ckpt),
                   ("--bicodec-ckpt", args.bicodec_ckpt))
    device = _device(args.device)
    unise = _build_unise(ckpt=args.ckpt, device=device,
                         bicodec_ckpt=args.bicodec_ckpt)
    # resampled after the build, which turns TF32 off for its conv
    wav, fs = read_wav(args.input)
    wav = _prepare_wav(wav, fs, device=device)
    enroll = None
    if args.enroll:
        e, efs = read_wav(args.enroll)
        enroll = _prepare_wav(e, efs, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.mode == "se":
        write_wav(args.output, unise.enhance_se(wav, gen, args.sample),
                  TARGET_SR)
    elif args.mode == "tse":
        write_wav(args.output, unise.enhance_tse(wav, enroll, gen,
                                                 args.sample), TARGET_SR)
    else:
        out = Path(args.output)
        for name, est in zip(("_s1", "_s2"),
                             unise.separate_ss(wav, gen, args.sample)):
            write_wav(out.with_name(out.stem + name + ".wav"), est,
                      TARGET_SR)
    print("done" + ("" if args.ckpt else " (random weights)"))
    return unise


def _build_utmos(path, device="cpu", cfg=None, ssl_cfg=None):
    """The learned UTMOS predictor from a checkpoint (``eval/utmos.py``):
    its head (``cfg``, default ``UTMOSConfig()``) from the canonical or the
    UTMOS22 layout, and its HuBERT (``ssl_cfg``, default HuBERT-base) from
    the ``ssl_model.*`` keys, random from seed 0 if there are none (with a
    warning), on ``device``."""
    from .eval.utmos import (UTMOSConfig, UTMOSHead, UTMOSPredictor,
                             utmos_head_keys, utmos_ssl_keys)
    from .models.ssl.wav2vec2 import Wav2Vec2Model, hubert_base_config
    from .utils.initialization import init_random_

    sd = _torch_state_dict(path, device)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.device(device):
        head = UTMOSHead(cfg or UTMOSConfig())
        ssl = Wav2Vec2Model(ssl_cfg or hubert_base_config())
    init_random_(ssl, gen)
    ssl_sd = utmos_ssl_keys(sd)
    load_state(head, utmos_head_keys(
        {k: v for k, v in sd.items() if not k.startswith("ssl_model.")}),
        f"UTMOS state dict {path}")
    if ssl_sd:
        load_state(ssl, ssl_sd, f"UTMOS ssl_model.* of {path}")
        print(f"loaded UTMOS head + SSL backbone from {path}",
              file=sys.stderr)
    else:
        print("WARNING: UTMOS ckpt has no ssl_model.* weights: the SSL "
              "backbone stays random; convert it separately",
              file=sys.stderr)
    return UTMOSPredictor(ssl, head)


def cmd_eval(args):
    """Evaluate UniSE over a directory of wavs (``eval/runner.py``): the
    enhanced outputs scored against the clean references of ``--tgt-dir``
    (STOI, PESQ, MOS-LQO, SI-SNR, LSD, the UTMOS proxy or, with
    ``--utmos-ckpt``, learned UTMOS, and SPK-SIM through BiCodec's speaker
    encoder with ``--bicodec-ckpt`` or ``--spk-sim``); prints the summary as
    one JSON line and returns it."""
    from .eval.metrics import make_spk_embed_fn
    from .eval.runner import EvalConfig, evaluate

    _require_files(("--test-dir", args.test_dir), ("--ckpt", args.ckpt),
                   ("--bicodec-ckpt", args.bicodec_ckpt),
                   ("--utmos-ckpt", args.utmos_ckpt))
    device = _device(args.device)
    # SPK-SIM scores through the BiCodec ECAPA x-vector branch: meaningful
    # only with converted speaker weights, so it is gated on
    # --bicodec-ckpt (or forced with --spk-sim, which warns loudly)
    spk_sim = bool(args.bicodec_ckpt or args.spk_sim)
    unise = _build_unise(ckpt=args.ckpt, device=device,
                         bicodec_ckpt=args.bicodec_ckpt, speaker=spk_sim)
    cfg = EvalConfig(mode=args.mode, data_src_dir=args.test_dir,
                     data_tgt_dir=args.tgt_dir,
                     data_enroll_dir=args.enroll_dir,
                     save_enhanced=args.save_enhanced, limit=args.max_items)
    utmos_pred = (_build_utmos(args.utmos_ckpt, device)
                  if args.utmos_ckpt else None)
    spk = None
    if spk_sim:
        if not args.bicodec_ckpt:
            print("WARNING: --spk-sim without --bicodec-ckpt: SPK-SIM will "
                  "be computed with RANDOM ECAPA weights and is meaningless",
                  file=sys.stderr)
        spk = make_spk_embed_fn(unise.tokenizer.model)
    else:
        print("note: SPK-SIM skipped (pass --bicodec-ckpt for converted "
              "speaker weights, or --spk-sim to force)", file=sys.stderr)
    stats = evaluate(unise, cfg, seed=args.seed, spk_embed_fn=spk,
                     utmos_predictor=utmos_pred)
    print(json.dumps(stats))
    return stats


HCODEC_NAMES = {"hcodec10": "HCodec-1.0", "hcodec20": "HCodec-2.0"}
# ``codec --dtype``: float32 keeps the modules as built, bfloat16 is the
# serving mode
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _build_hcodec(model: str = "hcodec10", ckpt=None, seed: int = 0,
                  device="cpu", cfg=None, ssl_cfg=None, dtype=None):
    """HCodec-1.0 or -2.0 (``model``; ``cfg`` defaults to its shipped
    config) with a HuBERT frontend (``ssl_cfg``, default HuBERT-base) on
    ``device``, fp32, TF32 off. Random weights from ``seed`` through an
    explicit generator, with a loud warning; ``ckpt`` replaces the codec's
    weights with a state dict in the layout of ``utils/convert.py``
    (``hcodec10_state_dict`` / ``hcodec20_state_dict``, or a training
    state dict, under "gen" in a ``train-codec`` checkpoint), loaded
    strictly after ``hcodec_inference_keys`` (the HuBERT frontend stays
    random). ``dtype`` (``torch.bfloat16``: the serving mode) casts codec
    and HuBERT after the weights are in place."""
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
    return HCodecTokenizer(codec, ssl, dtype=dtype)


def _build_hcodec15(ckpt=None, seed: int = 0, device="cpu", cfg=None,
                    ssl_cfg=None):
    """HCodec-1.5 adaptive (``cfg`` defaults to ``adaptive15_config()``)
    over XLSR-53 (``ssl_cfg``) on ``device``, fp32, TF32 off. Random
    weights from ``seed`` through an explicit generator, with a loud
    warning; ``ckpt`` loads a state dict in the reference layout (what
    ``export_hcodec15_state_dict`` writes; weight norm folded or as
    ``weight_g``/``weight_v``, folded on the host) into the codec, and
    XLSR-53 stays random, as in the JAX package."""
    from .models.hcodec.adaptive import AdaptiveHCodec, adaptive15_config
    from .models.hcodec.adaptive_tokenizer import AdaptiveHCodecTokenizer
    from .models.ssl.wav2vec2 import (Wav2Vec2Model,
                                      wav2vec2_large_xlsr53_config)
    from .utils.convert import hcodec15_inference_keys
    from .utils.initialization import init_random_

    _fp32_without_tf32()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        codec = AdaptiveHCodec(cfg or adaptive15_config())
        ssl = Wav2Vec2Model(ssl_cfg or wav2vec2_large_xlsr53_config())
    for module in (codec, ssl):
        init_random_(module, gen)
    if ckpt:
        sd = hcodec15_inference_keys(_torch_state_dict(ckpt))
        load_state(codec, {k: torch.as_tensor(v) for k, v in sd.items()},
                   f"HCodec-1.5 state dict {ckpt}")
        print(f"loaded HCodec-1.5 state dict {ckpt} (XLSR-53 stays random)",
              file=sys.stderr)
    else:
        print("WARNING: no --ckpt given: HCodec-1.5 and XLSR-53 are RANDOMLY "
              "initialized and the reconstruction is not meaningful "
              "(smoke/benchmark use only)", file=sys.stderr)
    return AdaptiveHCodecTokenizer(codec, ssl)


def _build_flexicodec(ckpt=None, seed: int = 0, device="cpu", cfg=None):
    """FlexiCodec in the DualCodec mode at 16 kHz (``cfg`` defaults to
    ``FlexiCodecConfig(sample_rate=16000)``) on ``device``, fp32, TF32 off.
    Random weights from ``seed`` with a loud warning, or ``ckpt`` (``.pt``
    or ``.safetensors``, the reference layout that
    ``export_flexicodec_state_dict`` writes, weight norm folded on the
    host); the checkpoint's ``convnext_encoder.0`` input width sets
    ``ssl_dim``."""
    import dataclasses

    from .models.hcodec.flexicodec import FlexiCodec, FlexiCodecConfig
    from .utils.convert import flexicodec_inference_keys
    from .utils.initialization import init_random_

    _fp32_without_tf32()
    sd, kw = None, dict(sample_rate=TARGET_SR)
    if ckpt:
        sd = flexicodec_inference_keys(_read_state_dict(ckpt))
        w = sd.get("convnext_encoder.0.weight")
        if w is not None:
            kw["ssl_dim"] = int(w.shape[1])
    cfg = dataclasses.replace(cfg or FlexiCodecConfig(), **kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        model = init_random_(FlexiCodec(cfg), gen).eval()
    if sd is not None:
        load_state(model, {k: torch.as_tensor(v) for k, v in sd.items()},
                   f"FlexiCodec state dict {ckpt}")
        print(f"loaded FlexiCodec state dict {ckpt} (ssl_dim="
              f"{cfg.ssl_dim})", file=sys.stderr)
    else:
        print("WARNING: no --ckpt given: FlexiCodec is RANDOMLY initialized "
              "and the reconstruction is not meaningful (smoke/benchmark use "
              "only)", file=sys.stderr)
    return model


def _build_sensevoice(path, device="cpu", cfg=None):
    """The SAN-M teacher (``SenseVoiceSemanticEncoder``, ``cfg`` defaults
    to ``sensevoice_small_config()``) from a funasr SenseVoiceSmall state
    dict, on ``device``, fp32."""
    from .models.ssl.sanm import (SenseVoiceSemanticEncoder,
                                  sensevoice_small_config)
    from .utils.convert import sensevoice_keys

    cfg = cfg or sensevoice_small_config()
    with torch.device(device):
        enc = SenseVoiceSemanticEncoder(cfg)
    sd = sensevoice_keys(_torch_state_dict(path), cfg)
    load_state(enc, {k: torch.as_tensor(v) for k, v in sd.items()},
               f"SenseVoice state dict {path}")
    return enc.eval()


def flexicodec_semantic(x, ssl_dim: int, cmvn=None, teacher=None):
    """The semantic stream of wav x (B, T), in the JAX package's order: the
    SAN-M ``teacher`` (a ``SenseVoiceSemanticEncoder``; needs ``cmvn``),
    else the teacher's frontend alone (``cmvn``), else the log-fbank
    fallback; at its own frame rate, ``ssl_dim`` wide."""
    from .models.hcodec.flexicodec import (fbank_semantic,
                                           sensevoice_semantic,
                                           sensevoice_teacher_semantic)

    if teacher is not None:
        return sensevoice_teacher_semantic(teacher, x, cmvn, TARGET_SR,
                                           ssl_dim)
    if cmvn:
        return sensevoice_semantic(x, cmvn, ssl_dim, TARGET_SR)
    return fbank_semantic(x, TARGET_SR, out_dim=ssl_dim)


def _codec_summary(model, rate, acoustic, output):
    summary = {"model": model, "tokens_per_sec": round(rate, 2),
               "acoustic_shape": list(acoustic.shape), "out": str(output)}
    print(json.dumps(summary))
    return summary


def _codec_hcodec15(args, device):
    """The HCodec-1.5 round trip; tokens_per_sec is the realised group
    rate."""
    tok = _build_hcodec15(ckpt=args.ckpt, seed=args.seed, device=device)
    wav, fs = read_wav(args.input)
    x = torch.as_tensor(_prepare_wav(wav, fs, TARGET_SR, device),
                        device=device)
    codes = tok.tokenize(x)
    rec = tok.detokenize(codes["acoustic_codes"], codes["semantic_codes"])
    write_wav(args.output, rec[0].cpu().numpy(), TARGET_SR)
    return _codec_summary(args.model, float(codes["token_rate_hz"].mean()),
                          codes["acoustic_codes"], args.output)


def _codec_flexicodec(args, device):
    """The FlexiCodec round trip on the semantic stream of
    :func:`flexicodec_semantic`, rate-matched to twice the frames."""
    from .models.hcodec.flexicodec import match_frame_rate

    if args.sensevoice_ckpt and not args.cmvn:
        sys.exit("error: --sensevoice-ckpt needs the teacher's CMVN stats "
                 "(--cmvn am.mvn)")
    _require_files(("--cmvn", args.cmvn),
                   ("--sensevoice-ckpt", args.sensevoice_ckpt))
    model = _build_flexicodec(ckpt=args.ckpt, seed=args.seed, device=device)
    teacher = None
    if args.sensevoice_ckpt:
        teacher = _build_sensevoice(args.sensevoice_ckpt, device)
        print(f"SAN-M teacher semantic stream from {args.sensevoice_ckpt}",
              file=sys.stderr)
    wav, fs = read_wav(args.input)
    wav = _prepare_wav(wav, fs, TARGET_SR, device)
    x = torch.as_tensor(wav, device=device)
    with torch.no_grad():
        sem = flexicodec_semantic(x, model.config.ssl_dim, args.cmvn,
                                  teacher)
        sem = match_frame_rate(
            sem, 2 * (wav.shape[-1] // model.config.hop_length))
        acoustic, semantic = model.encode(x, sem)
        rec = model.decode(acoustic, semantic)
    write_wav(args.output, rec[0].cpu().numpy(), TARGET_SR)
    return _codec_summary(args.model,
                          acoustic.shape[1] / (wav.shape[-1] / TARGET_SR),
                          acoustic, args.output)


def cmd_codec(args):
    """tokenize -> detokenize one wav at the codec's rate; prints and
    returns the JSON line of the JAX package's ``cmd_codec``."""
    if not Path(args.input).exists():
        sys.exit(f"error: input file not found: {args.input}")
    if args.ckpt and not Path(args.ckpt).exists():
        sys.exit(f"error: checkpoint not found: {args.ckpt}")
    if args.dtype != "float32" and args.model not in HCODEC_NAMES:
        sys.exit(f"error: --dtype {args.dtype} is the serving mode of "
                 f"{' and '.join(HCODEC_NAMES)}; {args.model} runs in "
                 "float32")
    if (args.cmvn or args.sensevoice_ckpt) and args.model != "flexicodec":
        sys.exit("error: --cmvn and --sensevoice-ckpt choose FlexiCodec's "
                 "semantic stream (--model flexicodec)")
    device = _device(args.device)
    if args.model == "hcodec15":
        return _codec_hcodec15(args, device)
    if args.model == "flexicodec":
        return _codec_flexicodec(args, device)
    tok = _build_hcodec(args.model, ckpt=args.ckpt, seed=args.seed,
                        device=device, dtype=DTYPES[args.dtype])
    sr = tok.config.sample_rate
    wav, fs = read_wav(args.input)
    wav = _prepare_wav(wav, fs, sr, device)
    acoustic, semantic = tok.tokenize(torch.as_tensor(wav, device=device))
    rec = tok.detokenize(acoustic, semantic)[0].cpu().numpy()
    write_wav(args.output, rec, sr)
    # codes per second of audio per quantizer layer (25 Hz for hcodec10,
    # 12.5 Hz for hcodec20)
    return _codec_summary(args.model,
                          acoustic.shape[-1] / (wav.shape[-1] / sr),
                          acoustic, args.output)


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
    t.add_argument("--config", default=None,
                   help="YAML config whose 'lm' section names the LM's "
                        "stack (configs/unise_moonlight16b.yaml: the "
                        "Moonlight-16B-A3B backbone, built in bf16); "
                        "without it UniSE's own LM")
    t.add_argument("--slots", type=int, default=16)
    t.add_argument("--kv-quant", choices=["", "int8"], default="",
                   help="int8 KV block pool (half the pool bytes)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    t.set_defaults(fn=cmd_serve)
    e = sub.add_parser("enhance")
    e.add_argument("--mode", choices=["se", "tse", "ss"], default="se")
    e.add_argument("--input", required=True,
                   help="wav, resampled to 16 kHz if need be")
    e.add_argument("--output", required=True,
                   help="output wav; --mode ss writes <stem>_s1.wav and "
                        "<stem>_s2.wav beside it")
    e.add_argument("--enroll", default=None,
                   help="enrollment wav of the target speaker (tse)")
    e.add_argument("--ckpt", default=None,
                   help="LM state dict (.pt) in the reference layout; "
                        "omitted, the weights are random (with a warning)")
    e.add_argument("--bicodec-ckpt", default=None,
                   help="BiCodec state dict (.safetensors or .pt) in the "
                        "reference layout")
    e.add_argument("--sample", action="store_true",
                   help="sample the tokens (greedy by default)")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    e.set_defaults(fn=cmd_enhance)
    c = sub.add_parser("codec")
    c.add_argument("--model", choices=[*HCODEC_NAMES, "hcodec15",
                                       "flexicodec"], default="hcodec10",
                   help="HCodec-1.0 (16 kHz), HCodec-2.0 (48 kHz), "
                        "HCodec-1.5 adaptive or FlexiCodec (16 kHz)")
    c.add_argument("--input", required=True,
                   help="wav, resampled to the codec's rate if need be")
    c.add_argument("--output", required=True)
    c.add_argument("--ckpt", default=None,
                   help="codec state dict in the reference layout: .pt "
                        "(hcodec10/hcodec20 as utils/convert.py writes "
                        "them, hcodec15 as export_hcodec15_state_dict), or "
                        ".pt/.safetensors for flexicodec")
    c.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (no --ckpt)")
    c.add_argument("--dtype", choices=list(DTYPES), default="float32",
                   help="bfloat16 = the serving mode: bf16 weights and "
                        "activations, the VQ search (K6), the norm "
                        "statistics, softmax, HCodec-2.0's STFT and the "
                        "ISTFT head in fp32 (hcodec10 and hcodec20 only)")
    c.add_argument("--cmvn", default=None,
                   help="flexicodec: the SenseVoice teacher's am.mvn; the "
                        "semantic stream is then its fbank+LFR+CMVN "
                        "frontend (without it, a log-fbank fallback)")
    c.add_argument("--sensevoice-ckpt", default=None,
                   help="flexicodec: a funasr SenseVoiceSmall state dict; "
                        "the semantic stream is then the SAN-M teacher's "
                        "(needs --cmvn)")
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.set_defaults(fn=cmd_codec)
    ev = sub.add_parser("eval")
    ev.add_argument("--test-dir", required=True,
                    help="directory of the input wavs (*.wav)")
    ev.add_argument("--tgt-dir", default=None,
                    help="clean references of the same names (enables "
                         "STOI/PESQ/SI-SNR and the rest)")
    ev.add_argument("--enroll-dir", default=None,
                    help="enrollment wavs of the same names (tse)")
    ev.add_argument("--mode", choices=["se", "tse", "ss"], default="se")
    ev.add_argument("--ckpt", default=None,
                    help="LM state dict (.pt) in the reference layout")
    ev.add_argument("--bicodec-ckpt", default=None,
                    help="BiCodec state dict (.safetensors or .pt); "
                         "enables a meaningful SPK-SIM")
    ev.add_argument("--spk-sim", action="store_true",
                    help="force SPK-SIM even with random speaker weights")
    ev.add_argument("--utmos-ckpt", default=None,
                    help="UTMOS state dict (torch); switches the MOS column "
                         "from the proxy to learned UTMOS")
    ev.add_argument("--save-enhanced", default=None,
                    help="directory to write the enhanced wavs into")
    ev.add_argument("--max-items", type=int, default=None)
    ev.add_argument("--seed", type=int, default=0)
    ev.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ev.set_defaults(fn=cmd_eval)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
