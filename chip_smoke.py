#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unified_audio_tpu_torch) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); without them it exits non-zero and
prints no result. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi).
2. kernels: builds ``csrc/paged_attention.cu`` and ``csrc/vq.cu`` (one nvcc
   each, started together), then holds each kernel against its plain
   PyTorch version, both timed with CUDA events, plain and kernel in turns.
   The owner flash-decode kernels K1 (bf16/fp32 pool) and K2 (int8 pool) run
   at the serving shapes (16 slots, 12 layers, 8 heads of 64, 64-token
   blocks, 14-block regions in a 256-block pool, inactive slots, positions
   up to a region's end). Tolerances: fp32 within 1e-5 (abs and rel); bf16
   output within 2 bf16 ulps of the fp32 plain result on the same
   bf16-valued inputs (ulp floored at that of 2**-8). The VQ kernels K5
   (nearest code) and K6 (fused 4-layer residual encode) run on random fp32
   rows at M = 250 (one 10-s clip) and M = 2000 (eight), N = 1024, D = 512:
   codes equal to the plain search in >= 99.9% of places, every other one a
   near tie (fp64 distance excess <= 1e-5 (|x|^2 + max |e|^2)); K6 judged
   layer by layer on the residuals its own codes leave.
3. UniSE serving: serves synthetic 16 kHz requests (SE, TSE, rTSE; greedy
   and sampled; more 5-s segments than the 16 slots) at full UniSE width
   through ``unified_audio_tpu_torch.cli serve``, once with the int8 pool
   (K2) and once, shorter, with the bf16 pool (K1). Checks: 32 global and
   250 semantic ids in range per segment, finite output wavs of the input's
   length, each kernel launched 12 times per decode step, no plain
   attention run. Then, on two segments in fp32, teacher-forced decode
   steps through the kernels agree with the plain attention path: max
   |logit difference| within 1e-4.
4. HCodec-1.0 round trip: ``unified_audio_tpu_torch.cli codec --model
   hcodec10`` on a synthetic 10-s 16 kHz wav at full width with random
   weights, the plain VQ functions made to raise. Checks: codes (1, 4, 250)
   per stream in [0, 1024), a finite output wav of the input's length, K6
   launched exactly twice. Then the round trip's rtfx (audio seconds over
   the median wall time of 10 synchronized tokenize + detokenize runs); the
   staged encode (K5, one launch per layer) on the round trip's own latents
   against K6 under the near-tie rule; and the round trip with the plain
   VQ: codes equal in >= 99.9% of places and, where all are equal, the
   waveforms within 1e-5.
5. No module of jax, flax or the JAX package (``unified_audio_tpu``) was
   loaded at all.

Prints the rates, a JSON line of the kernels (launches from the paths
above, each kernel's time, its plain version's and its bound), and as its
last line the device JSON object.
"""
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
L = 12  # LM layers: each decode step launches K1 or K2 once per layer
K1_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:602"
K2_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:540"
K5_TPU = "unified_audio_tpu/ops/pallas/vq_kernel.py:45"
K6_TPU = "unified_audio_tpu/ops/pallas/vq_kernel.py:148"
SOURCE = "unified_audio_tpu_torch/csrc/paged_attention.cu"
VQ_SOURCE = "unified_audio_tpu_torch/csrc/vq.cu"
# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor and fp32 peaks
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12}
SR = 16000
CLIP_S = 10.0  # the round trip's clip, as bench.py times it
VQ_SHAPES = dict(n=1024, d=512, nq=4)  # HCodec-1.0: 4 x 1024 codes of 512


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
    """-> (max abs error vs the fp32 plain result, kernel ms, plain ms,
    (bound ms, bound by))."""
    args = pa.serving_case(quant, dtype, "cuda")
    err, ok = pa.compare_with_plain(kernel, ref, args)
    if not ok:
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or inactive slots not zero")
    # plain, kernel, kernel, plain: the two versions alternate
    t = [time_ms(torch, lambda f=f: f(*args)) for f in (ref, kernel, kernel,
                                                         ref)]
    return err, (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, owner_bound(args, quant)


def bound(bytes_moved, ops, ops_type):
    """-> (ms, "bytes" or "operations"): the least time the card could take,
    the larger of bytes over the HBM rate and operations over the peak."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[ops_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def owner_bound(args, quant):
    """Bound of one K1 or K2 call on ``args``: the live prefix's K and V
    rows read once (and, for the int8 pool, their scales), q, the start
    blocks and positions read and the output written once; two dot products
    of the head dim per key and head, at the rate of q's type."""
    q, index = args[0], args[-2].cpu()
    tokens = int((index[index >= 0] + 1).sum())
    h, hd = q.shape[1], q.shape[2]
    moved = (2 * tokens * h * hd * args[1].element_size()
             + 2 * q.numel() * q.element_size() + 2 * index.numel() * 4)
    if quant:
        moved += 2 * tokens * 4
    return bound(moved, 4 * tokens * h * hd,
                 "fp32" if q.element_size() == 4 else "bf16")


def vq_bound(m, n, d, nq):
    """Bound of an nq-layer search of M rows: x and the codebooks read
    once, the codes written once; 2 M N D operations per layer, fp32."""
    return bound(4 * (m * d + nq * n * d + m * nq), 2 * nq * m * n * d,
                 "fp32")


def check_vq(torch, vq, m):
    """K5 (layer 0) and K6 against the plain search on random rows of M at
    the HCodec-1.0 shapes -> {name: (share equal, worst excess, ms, plain
    ms)}."""
    x, cbs = vq.random_case(m, **VQ_SHAPES, seed=m)
    cb0 = cbs[0].contiguous()
    out = {}
    for name, kernel, ref, books in (
            ("K5", lambda: vq.nearest_code(x, cb0)[:, None],
             lambda: vq.nearest_code_ref(x, cb0), cbs[:1]),
            ("K6", lambda: vq.rvq_encode_fused(x, cbs),
             lambda: vq.rvq_encode_fused_ref(x, cbs), cbs)):
        codes = kernel()
        torch.cuda.synchronize()
        share, worst, ok = vq.judge_codes(x, books, codes)
        if not (share >= 0.999 and ok):
            fail(f"{name} at M={m}: {share:.5f} of codes equal to the plain "
                 f"search, worst distance excess {worst:.3e}")
        t = [time_ms(torch, f, iters=50) for f in (ref, kernel, kernel, ref)]
        out[name] = (share, worst, (t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    return out


# ---------------------------------------------------------------------------
# UniSE serving
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


# ---------------------------------------------------------------------------
# HCodec-1.0 round trip
# ---------------------------------------------------------------------------

def roundtrip_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Steps of phase 4 -> (K5 launches and K6 launches on their paths,
    round-trip rtfx)."""
    built = []
    build = cli._build_hcodec10

    def recording(**kw):
        built.append(build(**kw))
        return built[-1]

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    rng = np.random.default_rng(7)
    n = int(CLIP_S * SR)
    wav = 0.5 * synth_speech(rng, n) + 0.05 * rng.standard_normal(n)
    wav_in, wav_out = tmp / "clip.wav", tmp / "clip_out.wav"
    write_wav(wav_in, (0.8 * wav / np.abs(wav).max()).astype(np.float32), SR)
    guards = [(cli, "_build_hcodec10", recording),
              (vq, "nearest_code_ref", forbidden),
              (vq, "rvq_encode_fused_ref", forbidden)]
    with patched(guards):
        vq.nearest_code.launches = vq.rvq_encode_fused.launches = 0
        summary = cli.main(["codec", "--model", "hcodec10", "--input",
                            str(wav_in), "--output", str(wav_out)])
        k6_launches = vq.rvq_encode_fused.launches
        if k6_launches != 2:
            fail(f"K6 launched {k6_launches} times in one round trip, not 2")
        tok = built[0]
        x = torch.as_tensor(read_wav(wav_in)[0], device="cuda")
        codes = [c.cpu() for c in tok.tokenize(x)]
    if summary["acoustic_shape"] != [1, 4, 250]:
        fail(f"acoustic codes of shape {summary['acoustic_shape']}")
    for c in codes:
        if c.shape != (1, 4, 250) or not (0 <= int(c.min())
                                          and int(c.max()) < 1024):
            fail(f"codes of shape {tuple(c.shape)} in "
                 f"[{int(c.min())}, {int(c.max())}]")
    rec, fs = read_wav(wav_out)
    if not (fs == SR and rec.shape == (1, n) and np.isfinite(rec).all()):
        fail(f"round-trip wav of shape {rec.shape} at {fs} Hz")

    def roundtrip():
        return tok.detokenize(*tok.tokenize(x))

    roundtrip()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = roundtrip()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = float(np.median(times))
    rtfx = CLIP_S / wall
    print(f"hcodec10 round trip rtfx {rtfx:.2f} (median of 10: {wall * 1e3:.2f}"
          f" ms for {CLIP_S:.0f} s of 16 kHz audio; range "
          f"{min(times) * 1e3:.2f}-{max(times) * 1e3:.2f} ms); K6 launches "
          f"{k6_launches} | {gpu}", flush=True)

    # K5 on its own path: the staged encode of the round trip's latents
    latents = [z.reshape(-1, z.shape[-1]).contiguous() for z in tok.latents(x)]
    books = [q.codebooks() for q in (tok.codec.quantizer,
                                     tok.codec.semantic_quantizer)]
    vq.nearest_code.launches = 0
    staged = [vq.rvq_encode_staged(z, b) for z, b in zip(latents, books)]
    k5_launches = vq.nearest_code.launches
    if k5_launches != 8:
        fail(f"K5 launched {k5_launches} times in the staged encode, not 8")
    for z, b, got in zip(latents, books, staged):
        fused = vq.rvq_encode_fused(z, b)
        same = float((fused == got).float().mean())
        worst = 0.0
        for codes_ in (got, fused):
            share, w, ok = vq.judge_codes(z, b, codes_)
            worst = max(worst, w)
            if not ok:
                fail(f"staged/fused codes off the plain search: excess {w}")
        if same < 0.999:
            fail(f"staged K5 and fused K6 agree on {same:.5f} of codes")
        print(f"staged K5 vs fused K6 on the round trip's latents: {same:.5f}"
              f" of codes equal, worst distance excess {worst:.3e}; K5 "
              f"launches {k5_launches}", flush=True)

    # the round trip with the plain VQ, outside the guards
    with patched([(vq, "rvq_encode_fused", vq.rvq_encode_fused_ref)]):
        plain_codes = tok.tokenize(x)
    plain_out = tok.detokenize(*plain_codes)
    same = float(np.mean([float((a.cpu() == b).float().mean())
                          for a, b in zip(plain_codes, codes)]))
    diff = float((plain_out - out).abs().max())
    if same < 0.999 or (same == 1.0 and not diff <= 1e-5):
        fail(f"plain-VQ round trip: {same:.5f} of codes equal, waveform "
             f"max |diff| {diff:.3e}")
    print(f"round trip with plain VQ: {same:.5f} of codes equal, waveform "
          f"max |diff| {diff:.3e}", flush=True)
    return k5_launches, k6_launches, rtfx


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
    from unified_audio_tpu_torch.data.audio_io import read_wav, write_wav
    from unified_audio_tpu_torch.models.unise.model import UniSE
    from unified_audio_tpu_torch.ops.cuda import paged_attention as pa
    from unified_audio_tpu_torch.ops.cuda import vq
    from unified_audio_tpu_torch.ops.cuda.build import load_library
    from unified_audio_tpu_torch.serve import paged

    # 1. device
    gpu = gpu_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(gpu)
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{count} card(s)", flush=True)

    # 2. kernels: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(load_library, ("paged_attention.cu", "vq.cu")))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    results = {}
    for name, kernel, ref, quant in (
            ("K1", pa.paged_flash_decode_owner,
             pa.paged_flash_decode_owner_ref, False),
            ("K2", pa.paged_flash_decode_owner_q8,
             pa.paged_flash_decode_owner_q8_ref, True)):
        for dtype in (torch.float32, torch.bfloat16):
            err, ms, plain_ms, b = check_kernel(torch, pa, kernel, ref,
                                                 dtype, quant)
            results[name, dtype] = (err, ms, plain_ms, b)
            print(f"{name} {kernel.__name__} q {str(dtype)[6:]}: max abs err "
                  f"{err:.3e} vs fp32 plain; kernel {ms * 1e3:.1f} us, plain "
                  f"{plain_ms * 1e3:.1f} us per layer call, bound "
                  f"{b[0] * 1e3:.1f} us ({b[1]}) | {gpu}", flush=True)
    vq_results = {}
    for m in (250, 2000):
        for name, (share, worst, ms, plain_ms) in check_vq(torch, vq,
                                                           m).items():
            vq_results[name, m] = (worst, ms, plain_ms)
            b_ms, _ = vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"],
                               1 if name == "K5" else VQ_SHAPES["nq"])
            print(f"{name} at M={m}, N=1024, D=512"
                  f"{'' if name == 'K5' else ', nq=4'}: {share:.5f} of codes "
                  f"equal to plain, worst distance excess {worst:.3e}; kernel"
                  f" {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.1f} us | {gpu}", flush=True)

    # 3. UniSE serving
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

    # 4. HCodec-1.0 round trip
    with tempfile.TemporaryDirectory() as tmp:
        k5_launches, k6_launches, _ = roundtrip_phase(
            torch, cli, vq, gpu, Path(tmp), write_wav, read_wav)

    # 5. nothing of JAX or the JAX package was loaded
    jax_side = {m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "unified_audio_tpu")}
    if jax_side:
        fail(f"the port loaded JAX-side modules: {sorted(jax_side)}")

    # the kernels at the main path's shapes: K1/K2 bf16 at the serving
    # shapes, K5/K6 at one 10-s clip (M = 250); no single PyTorch call
    # computes any of them (a paged decode; a product and an argmin)
    kernels = []
    for name, fn, tpu in (("K1", pa.paged_flash_decode_owner, K1_TPU),
                          ("K2", pa.paged_flash_decode_owner_q8, K2_TPU)):
        err, ms, plain_ms, (b_ms, b_by) = results[name, torch.bfloat16]
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": SOURCE, "replaces": tpu,
                        "launches": launches[fn.__name__],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    for name, fn, tpu, n_launch, nq in (
            ("K5", vq.nearest_code, K5_TPU, k5_launches, 1),
            ("K6", vq.rvq_encode_fused, K6_TPU, k6_launches, 4)):
        err, ms, plain_ms = vq_results[name, 250]
        b_ms, b_by = vq_bound(250, VQ_SHAPES["n"], VQ_SHAPES["d"], nq)
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": VQ_SOURCE, "replaces": tpu,
                        "launches": n_launch, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
