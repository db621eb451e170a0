#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unified_audio_tpu_torch) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); without them it exits non-zero and
prints no result. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi).
2. kernels: builds the owner flash-decode kernels K1 (bf16/fp32 pool) and
   K2 (int8 pool) from csrc/ and runs each at the serving shapes (16 slots,
   12 layers, 8 heads of 64, 64-token blocks, 14-block regions in a
   256-block pool, inactive slots, positions up to a region's end) against
   its plain PyTorch version. Tolerances: fp32 within 1e-5 (abs and rel);
   bf16 output within 2 bf16 ulps of the fp32 plain result on the same
   bf16-valued inputs (ulp floored at that of 2**-8). Both are timed with
   CUDA events.
3. slice: serves synthetic 16 kHz requests (SE, TSE, rTSE; greedy and
   sampled; more 5-s segments than the 16 slots) at full UniSE width
   through ``unified_audio_tpu_torch.cli serve``, once with the int8 pool
   (K2) and once, shorter, with the bf16 pool (K1). Checks: 32 global and
   250 semantic ids in range per segment, finite output wavs of the input's
   length, each kernel launched 12 times per decode step, no plain
   attention run, no JAX module loaded (of the JAX package only its
   numpy-only ``data.audio_io``). Then, on two segments in fp32,
   teacher-forced decode steps through the kernels agree with the plain
   attention path: max |logit difference| within 1e-4.

Prints the serving rate and wall time, a JSON line of the kernels, and as
its last line the device JSON object.
"""
import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
L = 12  # LM layers: each decode step launches K1 or K2 once per layer
K1_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:602"
K2_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:540"
SOURCE = "unified_audio_tpu_torch/csrc/paged_attention.cu"


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=200):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def check_kernel(torch, pa, kernel, ref, dtype, quant):
    """-> (max abs error vs the fp32 plain result, kernel ms, plain ms)."""
    args = pa.serving_case(quant, dtype, "cuda")
    err, ok = pa.compare_with_plain(kernel, ref, args)
    if not ok:
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or inactive slots not zero")
    # plain, kernel, kernel, plain: the two versions alternate
    t = [time_ms(torch, lambda f=f: f(*args)) for f in (ref, kernel, kernel,
                                                         ref)]
    return err, (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------

def synth_speech(rng, n):
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(90, 250)
    x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) / k
            for k in range(1, 8))
    x *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    return x / np.abs(x).max()


def write_requests(tmp, rng, write_wav, spec, name):
    """spec: (task, mix seconds, sampled) -> JSONL file of requests with
    synthetic mixes (speech-like tone + noise) and 5-s enrolls."""
    lines = []
    for i, (task, secs, sampled) in enumerate(spec):
        n = int(secs * 16000)
        mix = 0.6 * synth_speech(rng, n) + 0.3 * rng.standard_normal(n)
        line = {"task": task, "mix": str(tmp / f"{name}_mix{i}.wav"),
                "output": str(tmp / f"{name}_out{i}.wav"),
                "do_sample": sampled}
        write_wav(line["mix"], (0.5 * mix / np.abs(mix).max()).astype(
            np.float32), 16000)
        if task != "se":
            line["enroll"] = str(tmp / f"{name}_enroll{i}.wav")
            write_wav(line["enroll"], (0.4 * synth_speech(rng, 80000)).astype(
                np.float32), 16000)
        lines.append(line)
    path = tmp / f"{name}.jsonl"
    path.write_text("\n".join(json.dumps(l) for l in lines))
    return path, lines


@contextmanager
def patched(pairs):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    for obj, name, value in pairs:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def serve_and_check(torch, cli, path, lines, kv_quant, records, read_wav):
    argv = ["serve", "--requests", str(path)]
    if kv_quant:
        argv += ["--kv-quant", kv_quant]
    records.clear()
    summary = cli.main(argv)
    st = summary["engine_stats"]
    if len(records) != len(lines) or st["requests_completed"] != \
            summary["segments"]:
        fail(f"served {st['requests_completed']} of {summary['segments']} "
             "segments")
    for line, (g, s, wav, orig_len) in zip(lines, records):
        if g.shape[1:] != (32,) or s.shape[1:] != (250,):
            fail(f"token shapes {g.shape} {s.shape}")
        if not (0 <= g.min() and g.max() < 4096 and 0 <= s.min()
                and s.max() < 8192):
            fail("token ids out of range")
        out, fs = read_wav(line["output"])
        mix, _ = read_wav(line["mix"])
        if not (np.isfinite(wav).all() and wav.shape == (orig_len,)
                and out.shape == mix.shape and fs == 16000):
            fail(f"output {line['output']}: shape {out.shape} vs {mix.shape}")
    return summary


def decode_agreement(torch, unise, kv_quant, steps=24):
    """Teacher-forced greedy decode of two SE segments in fp32 through the
    owner kernels and through the plain attention: max |logit diff|."""
    from unified_audio_tpu_torch.models.lm.llama import range_mask
    from unified_audio_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                                      Request)
    from unified_audio_tpu_torch.serve.paged import paged_decode_ids

    sft = unise.sft.float()
    cfg = sft.cfg
    rng = np.random.default_rng(1)
    reqs = [Request(task_id=0, mix_wav=(0.5 * synth_speech(rng, 80000)
                                        ).astype(np.float32),
                    do_sample=False, uid=i) for i in range(2)]
    engines = {mode: ContinuousBatchingEngine(
        sft, num_slots=2, max_global=32, max_semantic=256, mix_buckets=(256,),
        kv_quant=kv_quant, use_kernel=mode, feature_fn=unise.wavlm_feats,
        frames_fn=unise.wavlm_frames) for mode in ("owner", "")}
    for eng in engines.values():
        eng.admit_many(reqs)
    dev = sft.codec_embedding.weight.device
    gmask = range_mask(cfg, cfg.global_offset, cfg.global_size, dev)
    ids = torch.full((2,), cfg.global_sos, dtype=torch.int32, device=dev)
    worst = 0.0
    with torch.no_grad():
        for _ in range(steps):
            logits = {}
            for mode, eng in engines.items():
                st = eng.state
                logits[mode] = paged_decode_ids(
                    cfg, sft, eng.pool, st["block_tables"], st["index"],
                    st["phase"] != 2, ids, eng.block_size,
                    eng._block_bound(), mode)
                st["index"] += 1
            worst = max(worst, (logits["owner"] - logits[""]).abs().max().item())
            ids = (logits[""] + gmask).argmax(-1).int()
    return worst


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA card")
    if not (REPO / "unified_audio_tpu_torch").is_dir():
        fail(f"run from a checkout: no unified_audio_tpu_torch beside {__file__}")
    sys.path.insert(0, str(REPO))
    from unified_audio_tpu_torch import cli
    # numpy-only wav I/O, the one module the port shares with the JAX package
    from unified_audio_tpu.data.audio_io import read_wav, write_wav
    from unified_audio_tpu_torch.models.unise.model import UniSE
    from unified_audio_tpu_torch.ops.cuda import paged_attention as pa
    from unified_audio_tpu_torch.ops.cuda.build import load_library
    from unified_audio_tpu_torch.serve import paged

    # 1. device
    gpu = gpu_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(gpu)
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{count} card(s)", flush=True)

    # 2. kernels
    t0 = time.perf_counter()
    load_library("paged_attention.cu")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    results = {}
    for name, kernel, ref, quant in (
            ("K1", pa.paged_flash_decode_owner,
             pa.paged_flash_decode_owner_ref, False),
            ("K2", pa.paged_flash_decode_owner_q8,
             pa.paged_flash_decode_owner_q8_ref, True)):
        for dtype in (torch.float32, torch.bfloat16):
            err, ms, plain_ms = check_kernel(torch, pa, kernel, ref, dtype,
                                              quant)
            results[name, dtype] = (err, ms, plain_ms)
            print(f"{name} {kernel.__name__} q {str(dtype)[6:]}: max abs err "
                  f"{err:.3e} vs fp32 plain; kernel {ms * 1e3:.1f} us, plain "
                  f"{plain_ms * 1e3:.1f} us per layer call | {gpu}",
                  flush=True)

    # 3. slice
    records = []
    decode = UniSE._decode_tokens

    def recording(self, g, s, orig_len):
        wav = decode(self, g, s, orig_len)
        records.append((np.asarray(g), np.asarray(s), wav, orig_len))
        recording.unise = self
        return wav

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain attention path ran during serving")

    guards = [(UniSE, "_decode_tokens", recording),
              (paged, "_plain_attention", forbidden),
              (pa, "paged_flash_decode_owner_ref", forbidden),
              (pa, "paged_flash_decode_owner_q8_ref", forbidden)]
    rng = np.random.default_rng(0)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp, patched(guards):
        tmp = Path(tmp)
        spec1 = ([("se", 7.5, i % 2 == 1) for i in range(8)]
                 + [("tse", 7.5, False), ("tse", 7.5, True),
                    ("rtse", 7.5, False), ("rtse", 7.5, True)])
        spec2 = [("se", 5.0, False), ("se", 5.0, True), ("tse", 5.0, False),
                 ("rtse", 5.0, True)]
        for name, spec, quant, kernel in (
                ("int8", spec1, "int8", pa.paged_flash_decode_owner_q8),
                ("bf16", spec2, "", pa.paged_flash_decode_owner)):
            path, lines = write_requests(tmp, rng, write_wav, spec, name)
            pa.paged_flash_decode_owner.launches = 0
            pa.paged_flash_decode_owner_q8.launches = 0
            summary = serve_and_check(torch, cli, path, lines, quant, records,
                                      read_wav)
            n = kernel.launches
            launches[kernel.__name__] = n
            st = summary["engine_stats"]
            if n < L * st["decode_steps"]:
                fail(f"{kernel.__name__} launched {n} times for "
                     f"{st['decode_steps']} decode steps of {L} layers")
            print(f"serve {name} pool: {summary['requests']} requests, "
                  f"{summary['segments']} segments, {st['tokens_generated']} "
                  f"tokens, {st['decode_steps']} decode steps, "
                  f"{st['prefill_waves']} prefill waves; engine "
                  f"{summary['engine_s']:.2f} s = "
                  f"{st['tokens_generated'] / summary['engine_s']:.0f} "
                  f"tokens/s; wall {summary['wall_s']:.2f} s; "
                  f"{kernel.__name__} launches {n} | {gpu}", flush=True)
    jax_side = {m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "unified_audio_tpu")}
    if jax_side - {"unified_audio_tpu", "unified_audio_tpu.data",
                   "unified_audio_tpu.data.audio_io"}:
        fail(f"the port loaded JAX-side modules: {sorted(jax_side)}")
    unise = recording.unise
    for quant in (None, "int8"):
        worst = decode_agreement(torch, unise, quant)
        print(f"teacher-forced fp32 decode, {quant or 'fp32'} pool: owner "
              f"kernels vs plain attention max |logit diff| {worst:.2e}",
              flush=True)
        # sound kernels read 9.5e-7 (fp32 pool) and 7.5e-6 (int8 pool) on
        # an H100; a dropped or doubled key moves logits by far more
        if not worst <= 1e-4:
            fail(f"owner-kernel decode disagrees with the plain path: {worst}")

    kernels = []
    for name, fn, tpu in (("K1", pa.paged_flash_decode_owner, K1_TPU),
                          ("K2", pa.paged_flash_decode_owner_q8, K2_TPU)):
        err, ms, plain_ms = results[name, torch.bfloat16]
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": SOURCE, "replaces": tpu,
                        "launches": launches[fn.__name__],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
