"""Where an HCodec round trip's time goes, on one CUDA card.

    python -m unified_audio_tpu_torch.models.hcodec.profile_roundtrip \
        [--model hcodec10|hcodec20] [--out PROFILE.json] [--clips 1]

Builds HCodec-1.0 or 2.0 (``--model``) with the HuBERT-base frontend as
``cli codec`` does (full width, fp32, TF32 off, random weights from seed 0)
and, for ``--clips`` 10-s clips of unit-normal noise at the codec's rate
(16 or 48 kHz) in one batch (bench.py's input), measures:

* the round trip (tokenize + detokenize), synchronized wall time over 10
  runs after a warm-up, and the rtfx (audio seconds over the median);
* each stage alone, median of 5: HuBERT features (with the resampling to
  16 kHz for 2.0), the two encoders, the two RVQ encodes (K6), the decoder
  with the ISTFT head;
* three round trips under ``torch.profiler``: device kernel time per round
  trip, the device-busy share of the unprofiled round trip, kernel launches
  per round trip, and the kernels by device time.

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


def main(argv=None):
    p = argparse.ArgumentParser(prog="profile_roundtrip")
    p.add_argument("--model", choices=["hcodec10", "hcodec20"],
                   default="hcodec10")
    p.add_argument("--out", default=None, help="write the results as JSON")
    p.add_argument("--clips", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_roundtrip: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from ...cli import _build_hcodec

    tok = _build_hcodec(args.model, device="cuda")
    codec = tok.codec
    wav = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (args.clips, int(CLIP_S * tok.config.sample_rate))).astype(
            np.float32), device="cuda")
    results = []

    def emit(rec):
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def roundtrip():
        return tok.detokenize(*tok.tokenize(wav))

    first_ms, _ = _median_ms(roundtrip, 1)
    wall_ms, times = _median_ms(roundtrip, 10)
    emit({"phase": "roundtrip", "model": args.model, "clips": args.clips,
          "first_ms": first_ms,
          "median_ms": wall_ms, "min_ms": min(times), "max_ms": max(times),
          "rtfx": args.clips * CLIP_S / (wall_ms / 1e3),
          "device": torch.cuda.get_device_name(0)})

    with torch.no_grad():
        feats = tok.extract_features(wav)
        emb, sem = tok.latents(wav)
        ac, sc = codec.quantizer.encode(emb), codec.semantic_quantizer.encode(
            sem)
        stages = {
            "hubert_features": lambda: tok.extract_features(wav),
            "acoustic_encoder": lambda: codec.encoder(
                wav[..., None] if codec.config.version == "1.0" else wav),
            "semantic_encoder": lambda: codec.semantic_encoder(feats),
            "rvq_encode_x2": lambda: (codec.quantizer.encode(emb),
                                      codec.semantic_quantizer.encode(sem)),
            "decode": lambda: codec.decode(ac, sc),
        }
        emit({"phase": "stages", **{name: _median_ms(fn, 5)[0]
                                    for name, fn in stages.items()}})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            roundtrip()
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
    device_ms = 1e-3 * device_us / PROFILED if by_kernel else None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": "profile", "round_trips": PROFILED,
          # None: the profiler saw no device activity (not measured)
          "device_ms_per_roundtrip": device_ms,
          "device_busy_share": device_ms / wall_ms if device_ms else None,
          "launches_per_roundtrip": launches / PROFILED,
          "top_kernels": [{"name": name[:100], "ms": 1e-3 * us / PROFILED,
                           "calls": n / PROFILED,
                           "share": us / device_us}
                          for name, (us, n) in top]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
