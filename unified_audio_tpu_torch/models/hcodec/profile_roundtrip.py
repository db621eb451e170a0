"""Where a codec round trip's time goes, on one CUDA card.

    python -m unified_audio_tpu_torch.models.hcodec.profile_roundtrip \
        [--model hcodec10|hcodec20|hcodec15|flexicodec] \
        [--dtype float32|bfloat16] [--out PROFILE.json] [--clips 1]

Builds the codec as ``cli codec`` does (full width, fp32 with TF32 off or,
with ``--dtype bfloat16``, HCodec-1.0/2.0's bf16 serving mode; random
weights from seed 0): HCodec-1.0 or 2.0 over HuBERT-base, HCodec-1.5
adaptive over XLSR-53, or FlexiCodec on the log-fbank semantic stream.
For ``--clips`` 10-s clips of unit-normal noise at the codec's rate (16 or
48 kHz) in one batch (bench.py's input) it measures:

* the round trip (tokenize + detokenize; FlexiCodec: the semantic stream,
  encode and decode), synchronized wall time over 10 runs after a warm-up,
  and the rtfx (audio seconds over the median);
* each stage alone, median of 5 (HCodec-1.0/2.0: HuBERT features, the two
  encoders, the two RVQ encodes (K6), the decoder with the ISTFT head;
  HCodec-1.5: XLSR-53 features, the encoders, the segmentation and the two
  aggregators, the two RVQ encodes (K6), the bottleneck and decoder;
  FlexiCodec: the semantic stream, the DAC encoder, the semantic adapter
  and FSQ, the DAC RVQ, the decode);
* three round trips under ``torch.profiler`` (:func:`profile_calls`):
  device kernel time per round trip, the device-busy share of the
  unprofiled round trip, kernel launches per round trip, and the kernels by
  device time.

Prints one JSON object per measurement and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
CLIP_S = 10.0
PROFILED = 3  # round trips under the profiler


def _median_ms(fn, runs):
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), times


def profile_calls(fn, calls: int = PROFILED, wall_ms=None):
    """``calls`` calls of ``fn`` under ``torch.profiler`` (CUPTI) -> {
    "device_ms" a call (None: the profiler saw no device activity),
    "device_busy_share" (device ms over ``wall_ms``, given the unprofiled
    wall time of a call), "launches" a call (kernel-launch API calls),
    "top_kernels" (the 15 longest by device time)}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel = defaultdict(lambda: [0.0, 0])  # name -> [us, calls]
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_kernel[ev.name]
            rec[0] += ev.time_range.elapsed_us()
            rec[1] += 1
        elif ev.name in LAUNCH_CALLS:
            launches += 1
    device_us = sum(us for us, _ in by_kernel.values())
    device_ms = 1e-3 * device_us / calls if by_kernel else None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return {"device_ms": device_ms,
            "device_busy_share": (device_ms / wall_ms
                                  if device_ms and wall_ms else None),
            "launches": launches / calls,
            "top_kernels": [{"name": name[:100], "ms": 1e-3 * us / calls,
                             "calls": n / calls, "share": us / device_us}
                            for name, (us, n) in top]}


def _hcodec(args, wav_of):
    """HCodec-1.0/2.0: (the round trip, a builder of its stages)."""
    from ...cli import DTYPES, _build_hcodec

    tok = _build_hcodec(args.model, device="cuda", dtype=DTYPES[args.dtype])
    codec, wav = tok.codec, wav_of(tok.config.sample_rate)

    def stages():
        feats = tok.extract_features(wav).to(tok.dtype)
        emb, sem = tok.latents(wav)
        wav_in = wav.to(tok.dtype)
        ac = codec.quantizer.encode(emb)
        sc = codec.semantic_quantizer.encode(sem)
        return {
            "hubert_features": lambda: tok.extract_features(wav),
            "acoustic_encoder": lambda: codec.encoder(
                wav_in[..., None] if codec.config.version == "1.0"
                else wav_in),
            "semantic_encoder": lambda: codec.semantic_encoder(feats),
            "rvq_encode_x2": lambda: (codec.quantizer.encode(emb),
                                      codec.semantic_quantizer.encode(sem)),
            "decode": lambda: codec.decode(ac, sc),
        }

    return (lambda: tok.detokenize(*tok.tokenize(wav))), stages


def _hcodec15(args, wav_of):
    """HCodec-1.5 adaptive: (the round trip, a builder of its stages)."""
    from ...cli import _build_hcodec15
    from .adaptive import similarity_group_ids

    tok = _build_hcodec15(device="cuda")
    codec, cfg = tok.codec, tok.codec.config
    x = tok.pad_wav(wav_of(16000))

    def stages():
        feats = tok.extract_features(x)
        emb, sem = codec.encoder(x[..., None]), codec.semantic_encoder(feats)
        a_groups, s_groups, _, _ = codec.align(x[..., None], feats)
        ac, sc = codec.encode(x[..., None], feats)

        def aggregate():
            gid = similarity_group_ids(sem, cfg.similarity_threshold,
                                       cfg.max_group_len)
            return (codec.acoustic_aggregator(emb, gid),
                    codec.semantic_aggregator(sem, gid))

        return {
            "xlsr_features": lambda: tok.extract_features(x),
            "encoders": lambda: (codec.encoder(x[..., None]),
                                 codec.semantic_encoder(feats)),
            "segment_and_aggregate": aggregate,
            "rvq_encode_x2": lambda: (
                codec.quantizer.encode(a_groups),
                codec.semantic_quantizer.encode(s_groups)),
            "bottleneck_and_decode": lambda: codec.decode(ac, sc),
        }

    def roundtrip():
        codes = tok.tokenize(x)
        return tok.detokenize(codes["acoustic_codes"],
                              codes["semantic_codes"])

    return roundtrip, stages


def _flexicodec(args, wav_of):
    """FlexiCodec on the log-fbank stream: (the round trip, a builder of
    its stages)."""
    from ...cli import _build_flexicodec, flexicodec_semantic
    from .flexicodec import match_frame_rate

    model = _build_flexicodec(device="cuda")
    cfg, wav = model.config, wav_of(16000)
    frames = 2 * (wav.shape[-1] // cfg.hop_length)

    def semantic():
        return match_frame_rate(flexicodec_semantic(wav, cfg.ssl_dim),
                                frames)

    def stages():
        z, s = model.streams(wav, semantic())
        sem_dec = model.convnext_decoder(model.fsq.from_indices(
            model.fsq.indices(model.convnext_encoder(s))))
        ac, sc = model.encode(wav, semantic())
        return {
            "semantic_stream": semantic,
            "dac_encoder": lambda: model.dac.encoder(wav[..., None]),
            "semantic_adapter_fsq": lambda: model.convnext_decoder(
                model.fsq.from_indices(model.fsq.indices(
                    model.convnext_encoder(s)))),
            "dac_rvq": lambda: model.dac.quantizer.encode(z - sem_dec),
            "decode": lambda: model.decode(ac, sc),
        }

    return (lambda: model.decode(*model.encode(wav, semantic()))), stages


SETUPS = {"hcodec10": _hcodec, "hcodec20": _hcodec, "hcodec15": _hcodec15,
          "flexicodec": _flexicodec}


@torch.no_grad()
def main(argv=None):
    p = argparse.ArgumentParser(prog="profile_roundtrip")
    p.add_argument("--model", choices=list(SETUPS), default="hcodec10")
    p.add_argument("--out", default=None, help="write the results as JSON")
    p.add_argument("--clips", type=int, default=1)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16: HCodec-1.0/2.0's serving mode")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_roundtrip: needs a CUDA card")
    if args.dtype != "float32" and args.model not in ("hcodec10",
                                                      "hcodec20"):
        sys.exit(f"profile_roundtrip: {args.model} runs in float32 only")

    def wav_of(sr):
        return torch.as_tensor(np.random.default_rng(0).standard_normal(
            (args.clips, int(CLIP_S * sr))).astype(np.float32),
            device="cuda")

    # the stages are set up after the first round trip, which is timed cold
    roundtrip, stages = SETUPS[args.model](args, wav_of)
    results = []

    def emit(rec):
        results.append(rec)
        print(json.dumps(rec), flush=True)

    first_ms, _ = _median_ms(roundtrip, 1)
    wall_ms, times = _median_ms(roundtrip, 10)
    emit({"phase": "roundtrip", "model": args.model, "clips": args.clips,
          "dtype": args.dtype,
          "first_ms": first_ms,
          "median_ms": wall_ms, "min_ms": min(times), "max_ms": max(times),
          "rtfx": args.clips * CLIP_S / (wall_ms / 1e3),
          "device": torch.cuda.get_device_name(0)})
    emit({"phase": "stages", **{name: _median_ms(fn, 5)[0]
                                for name, fn in stages().items()}})
    prof = profile_calls(roundtrip, PROFILED, wall_ms)
    emit({"phase": "profile", "round_trips": PROFILED,
          # None: the profiler saw no device activity (not measured)
          "device_ms_per_roundtrip": prof["device_ms"],
          "device_busy_share": prof["device_busy_share"],
          "launches_per_roundtrip": prof["launches"],
          "top_kernels": prof["top_kernels"]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
