#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unified_audio_tpu_torch) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); without them it exits non-zero and
prints no result. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi).
2. kernels: builds ``csrc/paged_attention.cu`` and ``csrc/vq.cu`` (one nvcc
   each, started together), then holds each kernel against its plain
   PyTorch version, plain and kernel in turns, each timed twice: its device
   time (the CUDA records one call leaves, summed from torch.profiler's
   CUPTI records; this is the ``ms`` of the kernels line) and its wall time
   per call with the host's dispatch (CUDA events around back-to-back
   calls). The timer counts the records by name: a window of N calls must
   hold N times one call's records, and one call exactly one record of the
   kernel under test (each window opens with ``LEAD_INS`` lead-in kernels,
   left out of the count, because a profiler session can lose its first
   device records); a window that does not is timed again once, then the
   run fails (``records`` on the kernels line: the kernel's records
   over its timed windows, so 400 for a decode kernel, four windows of
   100 calls, and 100 for K5/K6, two windows of 50). Every decode kernel (K1-K4, K7), its plain
   version and its library call are timed twice more in turns with the
   layer cycling 0..11, so that each call finds its layer out of L2 as in a
   decode step (``cold_ms`` on the kernels line; the calls above reuse one
   layer, warm in L2). K1 and K7 are the tiled kernels (K/V tiles staged
   in a shared-memory ring by cp.async, lane groups over the head
   dimension); K2, K3 and K4 the pipelined ones (256 threads per slot and
   head, two keys in flight a thread).
   The owner flash-decode kernels K1 (bf16/fp32 pool) and K2 (int8 pool) run
   at the serving shapes (16 slots, 12 layers, 8 heads of 64, 64-token
   blocks, 14-block regions in a 256-block pool, inactive slots, positions
   up to a region's end). The stream flash-decode kernels K3 (bf16/fp32
   pool) and K4 (int8 pool) run at the UniTok serving shapes (16 slots, a
   12-layer pool of 320 64-token blocks, the bound at 320, tables scattered
   as a ``BlockAllocator`` hands them out, inactive slots, a slot whose only
   keys lie in the last chunk, a row with no visible key, which must come
   out as finite zeros). The block-table flash-decode kernel K7 (bf16/fp32
   pool; no serving path launches it) runs at UniSE serving width (16
   slots, a 12-layer pool of 320 64-token blocks, 14-entry tables scattered
   by a ``BlockAllocator``, trash entries x100, a repeated block, an index
   past the table, inactive slots). K1, K3 and K7 are also timed against
   one ``scaled_dot_product_attention`` call on the same function (a
   boolean mask over the pool prefix). Tolerances:
   fp32 within 1e-5 (abs and rel); bf16
   output within 2 bf16 ulps of the fp32 plain result on the same
   bf16-valued inputs (ulp floored at that of 2**-8). The VQ kernels K5
   (nearest code) and K6 (fused 4-layer residual encode) run on random fp32
   rows at M = 240 (a 9.6-s clip, the most rows that take 16 a cluster),
   M = 250 (one 10-s clip, 32 a cluster) and M = 2000 (eight clips),
   N = 1024, D = 512:
   codes equal to the plain search in >= 99.9% of places, every other one a
   near tie (fp64 distance excess <= 1e-5 (|x|^2 + max |e|^2)); K6 judged
   layer by layer on the residuals its own codes leave. Both launch one
   kernel (the codebook split over a cluster of 8 CTAs, the argmin merged
   in distributed shared memory); before each M a line gives its plan:
   rows a cluster, clusters, the clusters the card holds at once
   (cudaOccupancyMaxActiveClusters) and the L2 bytes a call reads and
   writes, reckoned from the plan (``vq.l2_bytes``).
3. UniSE serving: serves synthetic 16 kHz requests (SE, TSE, rTSE; greedy
   and sampled; more 5-s segments than the 16 slots) at full UniSE width
   through ``unified_audio_tpu_torch.cli serve``, once with the int8 pool
   (K2) and once, shorter, with the bf16 pool (K1). The int8 pass also
   holds two "ss" lines (a 10-s and a 7.5-s mix: the separation cascade,
   its SE phase riding the first engine run with the other lines, then TSE
   and rTSE for every segment against enrollment rows made on the card)
   and an SE line whose mix is a 44.1 kHz wav (resampled to 16 kHz on the
   card). Checks: 32 global and 250 semantic ids in range per segment,
   finite output wavs of the input's length (of the 16 kHz length for the
   resampled line; ``<stem>_s1.wav`` and ``<stem>_s2.wav`` for each "ss"
   line), each kernel launched 12 times per decode step, no plain
   attention run, and every enrollment the cascades' TSE/rTSE requests
   carried a CUDA tensor. Then, on two segments in fp32, teacher-forced decode
   steps through the kernels agree with the plain attention path: max
   |logit difference| within 1e-4. On the fp32 pools those steps leave, K7
   (a seeded random q, every layer, each engine's block tables and
   positions) equals K1 on the owner engine's regions and K3 on the plain
   engine's allocator tables, within the fp32 tolerance above.
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
5. HCodec-2.0 round trip: ``cli codec --model hcodec20`` on a synthetic
   10-s 48 kHz wav at full width (``hcodec20_config()``: 1536-wide STFT
   encoder and decoder, 16 x 1024 codes a stream; HuBERT-base on the
   16-kHz resample; fp32, TF32 off) with random weights, the plain VQ
   functions made to raise. Checks: codes (1, 16, 125) per stream in [0,
   1024), a finite 48 kHz output of 480,000 samples, K6 launched exactly
   twice. The encoder's STFT on the card (cuFFT) against the same frames
   on the CPU: the DC and Nyquist bins' imaginary parts +0.0 and their
   phase equal (the line also counts the -0.0 that cuFFT itself gives
   there, before the STFT pins the sign). K6 at nq = 16 (every codebook
   slot of a launch) at M = 125 (the clip) and M = 1184 (32 clips of 3 s)
   against the plain search under ``judge_codes``, timed in turns, each M
   after its plan line. The rtfx of one 10-s clip (median of 10
   synchronized tokenize + detokenize runs) and of the
   ``benchmarks/bench_hcodec20.py`` configuration (encode + decode of 32
   clips of 142,080 samples with random HuBERT-shaped features, median of
   5, rtfx = 32 x 3 s over it, as that script counts). The round trip with
   the plain VQ: codes equal in >= 99.9% of places.
6. UniTok-audio at full width (``UniTokConfig``: 8 codebooks of 1024, LM
   512 x 12 layers, 8 heads of 64; bf16) over phase 4's HCodec-1.0, the
   plain attention paths made to raise. (a) ``UniTokEngine.run`` in the
   stream mode over an int8 pool (K4): 24 requests over the 7 tasks on 5-s
   synthetic inputs (250 HuBERT frames, 125 codec frames), VC/TSE with a
   2-s reference, LASS with 20 random caption frames, half sampled; codes
   (125, 8) in [0, 1024), through ``UniTokPipeline.codes_to_audio`` to
   finite 80,000-sample wavs, K4 launched 12 times per decode step, every
   bound a 64-block bucket within the pool. (b) One bf16 pool and one
   ``BlockAllocator`` shared by a UniSE engine (phase 3's LM) and a UniTok
   engine, both in the stream mode, stepped in turn (K3): disjoint blocks,
   outputs in range, K3 launched 12 times per step of each engine, no block
   left held; after the first steps, K7 with each engine's tables and
   positions equals K3 on the mask they give (bf16 tolerance, every
   layer). (c) Teacher-forced fp32 decode through K3 (fp32 pool) and K4
   (int8 pool) against the plain attention: max |logit difference| within
   1e-4. Prints UniTok codes per second of engine wall time.
7. UniSE SFT training at full width through ``cli train-unise`` (the LM
   512 x 12, 8 heads of 64; XLSR-53, 24 x 1024, and WavLM-base-plus
   frozen; the BiCodec encoder and speaker encoder; batch 32 x 5 s; fp32,
   TF32 off). Synthetic SCP lists (4 speakers x 3 utterances of 6 s of
   ``synth_speech``, a noise, an RIR) feed the host simulation; the config
   is ``configs/unise.yaml`` with the SCP paths, 30 steps
   (``samples_per_epoch``) of one epoch, a 5-step warmup, validation on
   the same lists every 15 steps (2 batches) and the checkpoint directory
   changed (printed). Checks: every step's loss finite, the validation
   loss lower at step 30 than at 15, a checkpoint at step 30. Prints the
   median step wall time over steps 5-30, training tokens/s (32 x 283
   targets a step), the device time of the frozen tokenize + features,
   the LM's forward + backward and the update (CUDA events), the host's
   wait between steps, the card's busy share over profiled step 20 and
   the peak memory allocated. Then one TSE batch of 2 x 5 s from a seed
   through the trained stack on the card and on a CPU copy: tokens equal
   in >= 99.9% of places, the loss within 1e-4 relative, each LM gradient
   within 1e-3 of its largest entry. A second ``train-unise`` on the same
   checkpoint directory must say it resumed at step 30 and run its first
   step at the schedule's rate for step 30. Last, ``cli serve --ckpt`` on
   the step-30 checkpoint with the int8 pool: a 10-s TSE line (2
   segments), K2 launched 12 times a decode step, a finite output of the
   input's length.
8. HCodec-1.0 GAN training at full width through ``cli train-codec``
   (``hcodec10_config()``: the SEANet encoder's convs trained as weight
   norm (g, v), 2 x 4 EMA codebooks of 1024 x 512 with k-means on the
   first batch and quantizer dropout, the semantic decoder; HuBERT-base
   frozen; MPD 2/3/5/7/11 + MS-STFT 1024/256, 2048/512, 512/128; batch 8 x
   3 s; fp32, TF32 off), the plain VQ search made to raise. The config is
   ``configs/hcodec10.yaml`` with only these changes (printed): a
   ``dataset`` of synthetic domain SCP lists (6 speech-like tone wavs as
   "speech", 6 noise wavs as "audio", 4 s each), 30 steps
   (``max_steps``), ``train.perceptual_start_step`` 10 (steps 11-30 run
   the adversarial terms and the discriminator) and the checkpoint
   directory in a temporary directory. Checks: every loss finite; the mel
   loss's mean over steps 26-30 below its mean over steps 1-5 within each
   domain seen in both (a batch is one domain's); after step 1 all 8
   layers initted with cluster sizes summing to the 600 rows a layer
   searches (the EMA of k-means' bins and the batch's counts); K5
   launched exactly 8 x 30 + 8 x 51 times (each layer's search a step,
   k-means' 50 iterations and final bins on step 1). Prints the median
   step wall time over steps 5-30, audio seconds trained a second (8 x 3
   s over it), the device time (CUDA events) of the HuBERT features, the
   generator's forward + backward, the discriminator's and the two
   updates, the host's time between steps, the busy share of profiled
   step 20 and the peak memory the run allocated beyond what the earlier
   phases hold. Then one generator step with
   the GAN terms of the trained codec on 2 x 3 s on the card and on a CPU
   copy (the same dropout cutoffs): the card's codes under
   ``judge_codes`` and equal to the CPU's in >= 99.9% of places, the
   losses within 1e-4 relative, each generator gradient within 1e-3 of
   its largest entry. K5 on the first layer's k-means start (600 rows
   against 1024 rows drawn from them with replacement, duplicates in
   different CTAs) equal to the plain search exactly, timed against it.
   Last, ``cli codec --ckpt`` on the step-30 checkpoint (weight norm
   folded on load) with a 10-s clip: K6 launched twice, codes (1, 4, 250)
   in [0, 1024), a finite output of the input's length.
9. The JAX CLI's remaining commands at full width, random weights. (a)
   ``cli enhance --mode se`` on a 7.5-s synthetic noisy wav (2 segments;
   the LM fp32), then ``--mode ss`` on it: outputs finite at the input's
   length, tokens in range; the generated tokens per second. The tokens
   of every generate call (SE; ss's SE, TSE and rTSE, the latter two with
   the enrollment the card's SE made) are teacher-forced through a CPU
   copy of the WavLM and LM: every card token within 1e-4 (relative) of
   the CPU's top logit in its range; prints the share equal to the CPU's
   argmax and the first step where they part. (b) ``cli codec --dtype bfloat16`` for ``hcodec10`` and
   ``hcodec20`` on 10-s clips, the plain VQ made to raise: K6 twice a
   round trip, the codec and its LSTMs in bf16, a finite output; the codes
   of a fp32 build of the same seed equal in >= 0.75 of places; K6's codes
   on the bf16 path's own fp32-cast latents under ``judge_codes``; their
   agreement with a bf16-rounded residual (the JAX package's bf16 encode;
   K6 keeps it fp32), by layer; the decode SNR of the same codes, bf16
   against fp32, above 15 dB; fp32 and bf16 round trips timed in turns,
   median of 10. (c) ``cli eval --mode se --spk-sim --utmos-ckpt`` (a
   random UTMOS head the smoke writes) over 4 noisy/clean pairs of 5 s:
   every metric finite; seconds an utterance. Then
   ``roundtrip_codec_eval`` through the bf16 HCodec-1.0 on the clean
   clips: K6 twice a clip.
10. No module of jax, flax or the JAX package (``unified_audio_tpu``) was
   loaded at all.

Prints the rates, a JSON line of the kernels (launches from the paths
above, each kernel's time, its plain version's and its bound; K2's
launches are phase 3's, and phase 7 prints its own serve's; K5's are
phase 4's staged encode and phase 8's training, and its ``kmeans_m600``
entry the times on k-means' start at M = 600; K6's are the round trips'
(phases 4, 5, 8 and 9's two bf16 ones and ``roundtrip_codec_eval``) and
its ``nq16`` entry the times at
HCodec-2.0's shapes; K7's launches are those of the serving paths, 0, and
the smoke's own check calls are printed on the line before), and as its
last line the device JSON object.
"""
import dataclasses
import itertools
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
K3_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:668"
K4_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:295"
K7_TPU = "unified_audio_tpu/ops/pallas/paged_attention.py:94"
K5_TPU = "unified_audio_tpu/ops/pallas/vq_kernel.py:45"
K6_TPU = "unified_audio_tpu/ops/pallas/vq_kernel.py:148"
SOURCE = "unified_audio_tpu_torch/csrc/paged_attention.cu"
VQ_SOURCE = "unified_audio_tpu_torch/csrc/vq.cu"
# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 and TF32 tensor and fp32
# peaks
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
SR = 16000
SR20 = 48000  # HCodec-2.0's rate
CLIP_S = 10.0  # the round trip's clip, as bench.py times it
VQ_SHAPES = dict(n=1024, d=512, nq=4)  # HCodec-1.0: 4 x 1024 codes of 512
NQ20 = 16  # HCodec-2.0: 16 x 1024 codes of 512 a stream
K6_20_M = (125, 1184)  # one 10-s clip; 32 clips of 3 s (bench_hcodec20.py)
BENCH20 = dict(batch=32, seconds=3.0)  # benchmarks/bench_hcodec20.py
# the CUDA function each wrapper launches once a call (as the profiler
# names it), whose records the timer counts
CUDA_KERNELS = {"paged_flash_decode_owner": "owner_decode_kernel_tiled",
                "paged_flash_decode_owner_q8": "owner_decode_kernel_pipelined",
                "paged_flash_decode_stream_flat":
                    "stream_decode_kernel_pipelined",
                "paged_flash_decode_stream_flat_q8":
                    "stream_decode_kernel_pipelined",
                "paged_flash_decode": "table_decode_kernel_tiled",
                "vq": "vq_search_kernel"}
ITERS = 100  # calls per timed window of a decode kernel (50 for K5/K6)
PAD_S = 0.02  # idle time at each end of a profiled window
LEAD_IN = "spin_kernel"  # the kernel of torch.cuda._sleep (ATen's Sleep.cu)
# lead-in kernels a window opens with: sessions lost their first device
# record (windows of plain K1 calls) and two records, a call's first two
# kernels in a one-call window (plain K6 at nq = 16, 177 records a call;
# H100, torch 2.11); ~300 s into a run (phase 8) windows lost records past
# the 8 lead-ins: 4 and 5 of the plain K5 search's 8 in one-call windows,
# in another the K5 kernel's one record
LEAD_INS = 8


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

def profiled(torch, fn, n, lead_in=True):
    """-> (CUDA records by name, their summed us) of ``n`` calls of ``fn``
    under torch.profiler (CUPTI). The window opens PAD_S before the first
    call and closes PAD_S after the card is done: the profiler keeps only
    the device records whose timestamps, mapped to the host's clock, fall
    inside its window. A session can also lose its first device records,
    so the window starts with a lead-in: ``LEAD_INS`` ``torch.cuda._sleep``
    kernels (``LEAD_IN``), waited for and left out of the result, then PAD_S
    more (``lead_in=False`` leaves it out, for ``profiler_windows.py``).
    The loss takes the first records, so a window that kept a lead-in
    record kept every call's; one that kept none is opened again with 8
    times the lead-ins (twice at most)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    tries = (LEAD_INS, 8 * LEAD_INS, 64 * LEAD_INS) if lead_in else (0,)
    for lead_ins in tries:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            if lead_ins:
                for _ in range(lead_ins):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(PAD_S)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        counts, us, leads = Counter(), 0.0, 0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if LEAD_IN in ev.name:
                leads += 1
            else:
                counts[ev.name] += 1
                us += ev.time_range.elapsed_us()
        if leads or not lead_ins:
            return counts, us
        print(f"chip_smoke: a window lost all {lead_ins} lead-in records",
              flush=True)
    fail(f"windows lost all of {tries} lead-in records")


def time_ms(torch, fn, iters, kernel=None):
    """-> (device ms, wall ms, records) per call of ``fn``. Device: the time
    of the CUDA records (kernels, copies) that ``iters`` calls leave under
    torch.profiler, summed. The records are counted by name: the window
    must hold ``iters`` times the records of one profiled call, name for
    name, and one call must launch exactly one kernel whose name holds
    ``kernel`` (where given); a window that does not is timed once more,
    then the run fails. ``records`` counts the window's ``kernel`` records.
    Wall: CUDA events around ``iters`` back-to-back calls; it holds the
    host's dispatch too wherever the host is slower than the card, as it is
    for a small decode kernel behind its wrapper's Python checks."""
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
    per_call, _ = profiled(torch, fn, 1)
    mine = sum(n for name, n in per_call.items() if kernel and kernel in name)
    if kernel is not None and mine != 1:
        fail(f"one call left {mine} records of {kernel}: {dict(per_call)}")
    want = {name: iters * n for name, n in per_call.items()}
    for _ in range(2):
        counts, us = profiled(torch, fn, iters)
        if dict(counts) == want and us > 0:
            return (1e-3 * us / iters, a.elapsed_time(b) / iters,
                    iters * mine)
        print(f"chip_smoke: {sum(counts.values())} CUDA records in a window "
              f"of {iters} calls, {sum(want.values())} expected; timing it "
              "again", flush=True)
    fail(f"the profiler's records of {iters} calls do not match one call's "
         f"{dict(per_call)}: {dict(counts)}")


def in_turns(torch, fns, iters=ITERS, kernels=None):
    """Times each of ``fns`` twice, in the order f0, f1, ..., f1, f0 (the
    versions alternate) -> [{"ms": device ms, "wall_ms": wall ms,
    "records": the records of ``kernels[i]`` over both windows}], the two
    timings of each averaged. ``kernels[i]`` names the one kernel a call of
    ``fns[i]`` launches (None for a plain version or a library call)."""
    n = len(fns)
    kernels = kernels or [None] * n
    t = [time_ms(torch, fns[i], iters, kernels[i])
         for i in list(range(n)) + list(range(n))[::-1]]
    return [{"ms": (t[i][0] + t[2 * n - 1 - i][0]) / 2,
             "wall_ms": (t[i][1] + t[2 * n - 1 - i][1]) / 2,
             "records": t[i][2] + t[2 * n - 1 - i][2]}
            for i in range(n)]


def cycling(call):
    """-> a function that calls ``call(0)``, ``call(1)``, ..., ``call(L -
    1)``, ``call(0)``, ...: one layer after another, as a decode step does,
    so that each call finds its layer's rows out of L2 (the 12 layers'
    pools far exceed its 50 MB)."""
    layers = itertools.cycle(range(L))
    return lambda: call(next(layers))


def at_layer(args, pos, li):
    out = list(args)
    out[pos] = li
    return out


def timed(torch, kernel, ref, args, li_pos, lib_at=None, rows=None):
    """The plain version, the kernel and, where given, the library call
    (``lib_at(li)`` builds it for layer ``li``) timed in turns, warm (100
    calls on layer ``args[li_pos]``) and cold (the layer cycling 0..11) ->
    {"ms"/"wall_ms": the kernel's warm, "plain_ms"/"plain_wall_ms": the
    plain version's, "library_ms" (None without ``lib_at``),
    "library_err": its max abs error against the plain version on the (S,)
    bool ``rows``, "cold_ms", "cold_plain_ms", "cold_library_ms": the
    device times of the cold calls, and "records": the kernel's CUDA
    records over its four timed windows}."""
    fns = [lambda: ref(*args), lambda: kernel(*args)]
    names = [None, CUDA_KERNELS[kernel.__name__]]
    cold = [cycling(lambda li: ref(*at_layer(args, li_pos, li))),
            cycling(lambda li: kernel(*at_layer(args, li_pos, li)))]
    out = {"library_ms": None, "cold_library_ms": None}
    if lib_at is not None:
        lib = lib_at(args[li_pos])
        fns.append(lib)
        want = ref(*args)[rows].float()
        got = lib()[0].transpose(0, 1)[rows].float()
        out["library_err"] = (got - want).abs().max().item()
        libs = [lib_at(li) for li in range(L)]
        cold.append(cycling(lambda li: libs[li]()))
    names += [None] * (len(fns) - 2)
    t = in_turns(torch, fns, kernels=names)
    out.update(t[1], plain_ms=t[0]["ms"], plain_wall_ms=t[0]["wall_ms"])
    c = in_turns(torch, cold, kernels=names)
    out.update(cold_ms=c[1]["ms"], cold_plain_ms=c[0]["ms"],
               records=t[1]["records"] + c[1]["records"])
    if lib_at is not None:
        out["library_ms"] = t[2]["ms"]
        out["cold_library_ms"] = c[2]["ms"]
    return out


def check_kernel(torch, pa, kernel, ref, dtype, quant):
    """K1 (float pool) or K2 (int8 pool) against its plain version at the
    UniSE serving shapes -> {"err": max abs error vs the fp32 plain result,
    "bound": (ms, bound by), and the times of ``timed``, K1's with its
    library call on the active slots}."""
    args = pa.serving_case(quant, dtype, "cuda")
    err, ok = pa.compare_with_plain(kernel, ref, args)
    if not ok:
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or inactive slots not zero")
    lib_at = None if quant else (
        lambda li: owner_sdpa_call(torch, at_layer(args, -1, li)))
    return {"err": err, "bound": owner_bound(args, quant),
            **timed(torch, kernel, ref, args, -1, lib_at, args[-2] >= 0)}


def report(name, kernel, dtype, r, gpu):
    lib = ("" if r.get("library_ms") is None else
           f"; scaled_dot_product_attention {r['library_ms'] * 1e3:.1f} us "
           f"(max abs err {r['library_err']:.3e} vs plain)")
    cold_lib = ("" if r.get("cold_library_ms") is None else
                f", library {r['cold_library_ms'] * 1e3:.1f} us")
    print(f"{name} {kernel.__name__} q {str(dtype)[6:]}: max abs err "
          f"{r['err']:.3e} vs fp32 plain; device time per layer call: kernel "
          f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us{lib}, "
          f"bound {r['bound'][0] * 1e3:.2f} us ({r['bound'][1]}); cold "
          f"(layers 0..11 in turn): kernel {r['cold_ms'] * 1e3:.2f} us, "
          f"plain {r['cold_plain_ms'] * 1e3:.2f} us{cold_lib}; wall per "
          f"call with dispatch: kernel {r['wall_ms'] * 1e3:.1f} us, plain "
          f"{r['plain_wall_ms'] * 1e3:.1f} us; {r['records']} kernel records "
          f"timed | {gpu}", flush=True)


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


def stream_bound(args, quant):
    """Bound of one K3 or K4 call on ``args``: the K and V rows any slot
    sees read once (and, for the int8 pool, their scales), the visibility
    mask, q and the output; two dot products of the head dim per visible
    (slot, key) pair and head, at the rate of q's type."""
    q, seen = args[0], args[-3] != 0
    keys = int(seen.any(0).sum())
    h, hd = q.shape[1], q.shape[2]
    moved = (2 * keys * h * hd * args[1].element_size() + seen.numel()
             + 2 * q.numel() * q.element_size())
    if quant:
        moved += 2 * keys * 4
    return bound(moved, 4 * int(seen.sum()) * h * hd,
                 "fp32" if q.element_size() == 4 else "bf16")


def sdpa_call(torch, args):
    """K3's function as one library call: scaled_dot_product_attention of
    q (1, H, S, hd) against the prefix as (1, H, nb*BS, hd) under the
    boolean visibility mask, inputs permuted beforehand."""
    q, kpool, vpool, vis, li, nb = args
    s, h, hd = q.shape

    def heads_first(pool):
        return pool[li, :nb].reshape(-1, h, hd).transpose(0, 1)[None] \
            .contiguous()

    qh = q.transpose(0, 1)[None].contiguous()
    k, v = heads_first(kpool), heads_first(vpool)
    mask = (vis != 0)[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, k, v, attn_mask=mask)


def owner_sdpa_call(torch, args):
    """K1's function as one library call: ``sdpa_call`` over the layer's
    pool prefix up to the last region's end (the first blocks plus the
    blocks the longest prefix spans) under the boolean mask of each slot's
    positions 0..index from its first block."""
    q, kpool, vpool, start, index, li = args
    bs = kpool.shape[2]
    nb = int(start.max()) + -(-(int(index.max()) + 1) // bs)
    key = torch.arange(nb * bs, device=q.device)
    first = start.long()[:, None] * bs
    vis = (key >= first) & (key <= first + index.long()[:, None])
    return sdpa_call(torch, [q, kpool, vpool, vis, li, nb])


def check_stream(torch, pa, kernel, ref, dtype, quant):
    """K3 (float pool) or K4 (int8 pool) against its plain version at the
    UniTok serving shapes -> the dict of ``check_kernel``, K3's with its
    library call on the rows with a visible key."""
    args = pa.stream_serving_case(quant, dtype, "cuda")
    empty = ~(args[-3] != 0).any(1)
    err, ok = pa.compare_with_plain(kernel, ref, args, empty=empty)
    if not (ok and bool(empty.any())):
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or rows with no visible key not finite zeros")
    lib_at = None if quant else (
        lambda li: sdpa_call(torch, at_layer(args, -2, li)))
    return {"err": err, "bound": stream_bound(args, quant),
            **timed(torch, kernel, ref, args, -2, lib_at, ~empty)}


def table_bound(args):
    """Bound of one K7 call on ``args``: the distinct K and V rows the
    active slots attend read once, q, the table entries the positions reach
    and the positions read and the output written once; two dot products
    of the head dim per attended (slot, position) pair and head, at the
    rate of q's type."""
    q, kpool, _, tables, index, _ = args
    bs, mb = kpool.shape[2], tables.shape[1]
    tables, index = tables.cpu().long(), index.cpu().long()
    pos = np.arange(mb * bs)
    seen = pos[None] <= index.numpy()[:, None]  # (S, MB*BS): table's only
    rows = tables.numpy()[:, pos // bs] * bs + pos % bs
    entries = int(np.minimum(-(-(index.numpy() + 1) // bs), mb).clip(0).sum())
    h, hd = q.shape[1], q.shape[2]
    moved = (2 * len(np.unique(rows[seen])) * h * hd * kpool.element_size()
             + 2 * q.numel() * q.element_size() + 4 * entries
             + 4 * index.numel())
    return bound(moved, 4 * int(seen.sum()) * h * hd,
                 "fp32" if q.element_size() == 4 else "bf16")


def check_table(torch, pa, kernel, ref, dtype, quant):
    """K7 against its plain version at ``table_serving_case`` -> the dict
    of ``check_kernel``, with its library call (``sdpa_call`` over the
    layer's whole pool under the visibility the tables give) judged on the
    active slots whose live prefix repeats no block."""
    from unified_audio_tpu_torch.serve.paged import table_visibility

    args = pa.table_serving_case(dtype, "cuda")
    err, ok = pa.compare_with_plain(kernel, ref, args)
    if not ok:
        fail(f"{kernel.__name__} {dtype}: max abs err {err} outside "
             "tolerance, or inactive slots not zero")
    q, kpool, vpool, tables, index, li = args
    nb, bs, mb = kpool.shape[1], kpool.shape[2], tables.shape[1]
    vis = table_visibility(tables, index, nb, bs)
    distinct = []
    for row, i in zip(tables.tolist(), index.tolist()):
        n = min(mb, i // bs + 1)
        distinct.append(i >= 0 and len(set(row[:n])) == n)
    return {"err": err, "bound": table_bound(args),
            **timed(torch, kernel, ref, args, -1,
                    lambda li: sdpa_call(torch, [q, kpool, vpool, vis, li,
                                                 nb]),
                    torch.tensor(distinct, device=q.device))}


@contextmanager
def uncounted(tally, *wrappers):
    """Kernel launches inside the block are the smoke's own check calls:
    they are added to ``tally`` (by wrapper name) and the wrappers' launch
    counts are left as they were."""
    saved = [w.launches for w in wrappers]
    try:
        yield
    finally:
        for w, n in zip(wrappers, saved):
            tally[w.__name__] = tally.get(w.__name__, 0) + w.launches - n
            w.launches = n


def table_on_live_pool(torch, pa, paged, eng, against, seed=11):
    """K7 on an engine's live pool, block tables and positions (-1 where a
    slot is inactive), a seeded random q, every layer, against K1
    (``against="K1"``: each table's first block as the region start) or K3
    (``"K3"``: the visibility the tables give over the whole pool) -> max
    abs error; fails outside ``compare_kernels``' tolerance."""
    from unified_audio_tpu_torch.serve.engine import PHASE_DONE

    st, k, v = eng.state, eng.pool["k"], eng.pool["v"]
    active = st["active"] if "active" in st else st["phase"] != PHASE_DONE
    index = torch.where(active, st["index"], -1).int()
    tables = st["block_tables"]
    g = torch.Generator(device=k.device).manual_seed(seed)
    q = torch.randn(len(index), k.shape[3] // 64, 64, generator=g,
                    device=k.device).to(k.dtype)
    if against == "K1":
        start = tables[:, 0].contiguous()

        def other(li):
            return pa.paged_flash_decode_owner(q, k, v, start, index, li)
    else:
        vis = paged.table_visibility(tables, index, k.shape[1],
                                     k.shape[2]).to(torch.int8)

        def other(li):
            return pa.paged_flash_decode_stream_flat(q, k, v, vis, li)
    worst = 0.0
    for li in range(k.shape[0]):
        err, ok = pa.compare_kernels(
            pa.paged_flash_decode(q, k, v, tables, index, li), other(li),
            index < 0)
        if not ok:
            fail(f"K7 against {against} on a live {k.dtype} pool, layer "
                 f"{li}: max abs err {err} outside tolerance")
        worst = max(worst, err)
    return worst


def vq_bound(m, n, d, nq):
    """Bound of an nq-layer search of M rows: x and the codebooks read
    once, the codes written once; 2 M N D operations per layer, each taken
    at fp32 accuracy as three TF32 products on the tensor cores (3xTF32, the
    kernel's route: three times the work at 495 TFLOP/s takes less time
    than fp32 at 67 TFLOP/s)."""
    return bound(4 * (m * d + nq * n * d + m * nq), 3 * 2 * nq * m * n * d,
                 "tf32")


def vq_plan_line(torch, vq, m, nq=VQ_SHAPES["nq"]):
    """-> (the cluster plan of a launch of M rows at N = 1024, D = 512 as
    one printable line, {"rows", "clusters", "active_clusters",
    "l2_bytes": {1 and nq: bytes}})."""
    n, d = VQ_SHAPES["n"], VQ_SHAPES["d"]
    rows = vq.plan(m, vq.active_clusters(d, 16))
    plan = {"rows": rows, "clusters": -(-m // rows),
            "active_clusters": vq.active_clusters(d, rows),
            "l2_bytes": {q: vq.l2_bytes(m, n, d, q, rows) for q in (1, nq)}}
    return (f"VQ plan at M={m}: {rows} rows a cluster of {vq.CLUSTER} CTAs "
            f"(codebook chunks of {-(-n // vq.CLUSTER)}), {plan['clusters']}"
            f" clusters, {plan['active_clusters']} active at once "
            f"(cudaOccupancyMaxActiveClusters); L2 bytes a call: K5 "
            f"{plan['l2_bytes'][1]}, K6 {plan['l2_bytes'][nq]}"), plan


def check_vq(torch, vq, m, nq=VQ_SHAPES["nq"], names=("K5", "K6")):
    """K5 (layer 0) and K6 (nq layers) against the plain search on random
    rows of M at N = 1024, D = 512 -> {name: (share equal, worst excess,
    ms, plain ms, records)} for the kernels in ``names``."""
    x, cbs = vq.random_case(m, **{**VQ_SHAPES, "nq": nq}, seed=m)
    cb0 = cbs[0].contiguous()
    out = {}
    for name, kernel, ref, books in (
            ("K5", lambda: vq.nearest_code(x, cb0)[:, None],
             lambda: vq.nearest_code_ref(x, cb0), cbs[:1]),
            ("K6", lambda: vq.rvq_encode_fused(x, cbs),
             lambda: vq.rvq_encode_fused_ref(x, cbs), cbs)):
        if name not in names:
            continue
        codes = kernel()
        torch.cuda.synchronize()
        share, worst, ok = vq.judge_codes(x, books, codes)
        if not (share >= 0.999 and ok):
            fail(f"{name} at M={m}: {share:.5f} of codes equal to the plain "
                 f"search, worst distance excess {worst:.3e}")
        plain, kern = in_turns(torch, [ref, kernel], iters=50,
                               kernels=[None, CUDA_KERNELS["vq"]])
        out[name] = (share, worst, kern["ms"], plain["ms"], kern["records"])
    return out


# ---------------------------------------------------------------------------
# UniSE serving
# ---------------------------------------------------------------------------

def synth_speech(rng, n, sr=SR):
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 250)
    x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) / k
            for k in range(1, 8))
    x *= 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    return x / np.abs(x).max()


def write_requests(tmp, rng, write_wav, spec, name):
    """spec: (task, mix seconds, sampled[, mix rate]) -> JSONL file of
    requests with synthetic mixes (speech-like tone + noise; 16 kHz unless
    a rate is given) and 5-s enrolls for TSE/rTSE."""
    lines = []
    for i, (task, secs, sampled, *rate) in enumerate(spec):
        sr = rate[0] if rate else SR
        n = int(secs * sr)
        mix = 0.6 * synth_speech(rng, n, sr) + 0.3 * rng.standard_normal(n)
        line = {"task": task, "mix": str(tmp / f"{name}_mix{i}.wav"),
                "output": str(tmp / f"{name}_out{i}.wav"),
                "do_sample": sampled}
        write_wav(line["mix"], (0.5 * mix / np.abs(mix).max()).astype(
            np.float32), sr)
        if task in ("tse", "rtse"):
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
    """``cli serve`` on ``lines``; checks every output (each regular line's,
    then each "ss" line's ``_s1``/``_s2``, the order the CLI decodes them
    in) -> (summary, [(line, output path)])."""
    argv = ["serve", "--requests", str(path)]
    if kv_quant:
        argv += ["--kv-quant", kv_quant]
    records.clear()
    summary = cli.main(argv)
    st = summary["engine_stats"]
    outputs = [(l, l["output"]) for l in lines if l["task"] != "ss"]
    for l in lines:
        if l["task"] == "ss":
            out = Path(l["output"])
            outputs += [(l, str(out.with_name(f"{out.stem}_s{k}.wav")))
                        for k in (1, 2)]
    if len(records) != len(outputs) or st["requests_completed"] != \
            summary["segments"] or summary["outputs"] != [
                o for _, o in outputs]:
        fail(f"served {st['requests_completed']} of {summary['segments']} "
             f"segments; {len(records)} decodes for {len(outputs)} outputs")
    for (line, out_path), (g, s, wav, orig_len) in zip(outputs, records):
        if g.shape[1:] != (32,) or s.shape[1:] != (250,):
            fail(f"token shapes {g.shape} {s.shape}")
        if not (0 <= g.min() and g.max() < 4096 and 0 <= s.min()
                and s.max() < 8192):
            fail("token ids out of range")
        out, fs = read_wav(out_path)
        mix, mix_fs = read_wav(line["mix"])
        n = -(-mix.shape[-1] * SR // mix_fs)  # the input's 16 kHz length
        if not (np.isfinite(wav).all() and wav.shape == (orig_len,)
                and out.shape == (1, n) and fs == SR
                and np.isfinite(out).all()):
            fail(f"output {out_path}: shape {out.shape} at {fs} Hz, the "
                 f"input {mix.shape} at {mix_fs} Hz")
    return summary, outputs


def check_cascades(torch, cli, lines, outputs, records, admitted, read_wav,
                   gpu):
    """The "ss" lines of a serve pass: prints each one's outputs, and fails
    unless every TSE/rTSE request of the cascades (2 per 5-s segment of
    each) carried its enrollment rows as a CUDA tensor, the rows of its
    own cascade's SE result (one tensor a cascade), and a resampled line
    came out at the 16 kHz length (checked by ``serve_and_check``)."""
    ss = [l for l in lines if l["task"] == "ss"]
    if not ss:
        return
    seg = 5 * SR
    want = sum(2 * -(-read_wav(l["mix"])[0].shape[-1] // seg) for l in ss)
    first = cli.SS_UID * 4 * 65536  # the cascades' engine uids start here
    phase2 = [r for u, r in admitted.items()
              if u >= first and r.task_id in (1, 2)]
    rows = {id(r.enroll_feats) for r in phase2}
    if len(phase2) != want or len(rows) != len(ss) or not all(
            torch.is_tensor(r.enroll_feats)
            and r.enroll_feats.device.type == "cuda" for r in phase2):
        fail(f"{len(phase2)} cascade TSE/rTSE requests ({want} expected) "
             f"over {len(rows)} enrollments, CUDA tensors: "
             f"{[getattr(r.enroll_feats, 'device', None) for r in phase2]}")
    for (line, out_path), (_, _, wav, _) in zip(outputs, records):
        mix, fs = read_wav(line["mix"])
        if line["task"] == "ss" or fs != SR:
            print(f"{line['task']} line, {mix.shape[-1]} samples at {fs} Hz"
                  f" -> {Path(out_path).name}: {wav.shape[0]} samples at "
                  f"{SR} Hz, peak {np.abs(wav).max():.4f}, finite | {gpu}",
                  flush=True)
    print(f"cascades: {len(ss)}, their {len(phase2)} TSE/rTSE requests "
          f"each carrying its cascade's enrollment rows, a "
          f"{tuple(phase2[0].enroll_feats.shape)} tensor on "
          f"{phase2[0].enroll_feats.device}", flush=True)


def decode_agreement(torch, unise, kv_quant, steps=24):
    """Teacher-forced greedy decode of two SE segments in fp32 through the
    owner kernels and through the plain attention -> (max |logit diff|,
    the engines by mode, holding the pools those steps left)."""
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
    return worst, engines


# ---------------------------------------------------------------------------
# HCodec-1.0 round trip
# ---------------------------------------------------------------------------

def median_wall(torch, fn, runs):
    """-> (median, min, max) seconds of ``runs`` synchronized calls of
    ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), min(times), max(times)


def roundtrip_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Steps of phase 4 -> (K5 launches and K6 launches on their paths,
    round-trip rtfx)."""
    built = []
    build = cli._build_hcodec

    def recording(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    rng = np.random.default_rng(7)
    n = int(CLIP_S * SR)
    wav = 0.5 * synth_speech(rng, n) + 0.05 * rng.standard_normal(n)
    wav_in, wav_out = tmp / "clip.wav", tmp / "clip_out.wav"
    write_wav(wav_in, (0.8 * wav / np.abs(wav).max()).astype(np.float32), SR)
    guards = [(cli, "_build_hcodec", recording),
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

    wall, lo, hi = median_wall(torch, roundtrip, 10)
    out = roundtrip()
    rtfx = CLIP_S / wall
    print(f"hcodec10 round trip rtfx {rtfx:.2f} (median of 10: {wall * 1e3:.2f}"
          f" ms for {CLIP_S:.0f} s of 16 kHz audio; range "
          f"{lo * 1e3:.2f}-{hi * 1e3:.2f} ms); K6 launches "
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
    return k5_launches, k6_launches, rtfx, tok


# ---------------------------------------------------------------------------
# HCodec-2.0 round trip
# ---------------------------------------------------------------------------

def stft_edges(torch, dsp, x, n_fft, hop):
    """The encoder's STFT of ``x`` (padded as ``CodecEncoder20`` pads it) on
    the card against the same frames on the CPU -> (the -0.0 imaginary
    parts cuFFT itself gives at the DC and Nyquist bins, of how many; bins
    there with a negative real part; max |S_card - S_cpu| / max |S|).
    Fails unless stft's DC and Nyquist bins are +0.0 and their phase
    equals the CPU's."""
    pad = (n_fft - hop) // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    raw = torch.fft.rfft(dsp.frame(xp, n_fft, hop) * dsp.hann_window(
        n_fft, x.device), n=n_fft, dim=-1)[..., [0, -1]]
    card = dsp.stft(xp, n_fft, hop).cpu()
    cpu = dsp.stft(xp.cpu(), n_fft, hop)
    edges = (slice(None), [0, -1])
    if torch.signbit(card[edges].imag).any() or not torch.equal(
            card[edges].angle(), cpu[edges].angle()):
        fail("the card's STFT phase at DC/Nyquist differs from the CPU's")
    return (int(torch.signbit(raw.imag).sum()), raw.numel(),
            int((cpu[edges].real < 0).sum()),
            float((card - cpu).abs().max() / cpu.abs().max()))


def hcodec20_phase(torch, cli, vq, dsp, gpu, tmp, write_wav, read_wav):
    """Phase 5 -> (K6 launches on the round trip, {M: (share, worst, ms,
    plain ms, records)} of K6 at nq = 16)."""
    built = []
    build = cli._build_hcodec

    def recording(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    rng = np.random.default_rng(8)
    n = int(CLIP_S * SR20)
    wav = 0.5 * synth_speech(rng, n, SR20) + 0.05 * rng.standard_normal(n)
    wav_in, wav_out = tmp / "clip48.wav", tmp / "clip48_out.wav"
    write_wav(wav_in, (0.8 * wav / np.abs(wav).max()).astype(np.float32),
              SR20)
    guards = [(cli, "_build_hcodec", recording),
              (vq, "nearest_code_ref", forbidden),
              (vq, "rvq_encode_fused_ref", forbidden)]
    with patched(guards):
        vq.rvq_encode_fused.launches = 0
        t0 = time.perf_counter()
        summary = cli.main(["codec", "--model", "hcodec20", "--input",
                            str(wav_in), "--output", str(wav_out)])
        cli_s = time.perf_counter() - t0
        k6_launches = vq.rvq_encode_fused.launches
        if k6_launches != 2:
            fail(f"K6 launched {k6_launches} times in one HCodec-2.0 round "
                 "trip, not 2")
        tok = built[0]
        x = torch.as_tensor(read_wav(wav_in)[0], device="cuda")
        codes = tok.tokenize(x)
    frames = n // tok.hop_length
    if summary["acoustic_shape"] != [1, NQ20, frames]:
        fail(f"HCodec-2.0 acoustic codes of shape {summary['acoustic_shape']}")
    for c in codes:
        if tuple(c.shape) != (1, NQ20, frames) or not (
                0 <= int(c.min()) and int(c.max()) < 1024):
            fail(f"HCodec-2.0 codes of shape {tuple(c.shape)} in "
                 f"[{int(c.min())}, {int(c.max())}]")
    rec, fs = read_wav(wav_out)
    if not (fs == SR20 and rec.shape == (1, n) and np.isfinite(rec).all()):
        fail(f"HCodec-2.0 round-trip wav of shape {rec.shape} at {fs} Hz")
    print(f"hcodec20 round trip through cli codec ({cli_s:.1f} s with the "
          f"build): codes {tuple(codes[0].shape)} per stream in "
          f"[{min(int(c.min()) for c in codes)}, "
          f"{max(int(c.max()) for c in codes)}], {len(torch.unique(codes[0]))}"
          f" distinct acoustic codes; output {rec.shape[1]} samples at {fs} "
          f"Hz, finite; K6 launches {k6_launches} | {gpu}", flush=True)

    neg0, n_edge, negative, rel = stft_edges(torch, dsp, x, tok.config.n_fft,
                                             tok.config.istft_hop)
    print(f"hcodec20 encoder STFT on the card vs the CPU: DC/Nyquist "
          f"imaginary parts -0.0 in cuFFT's own output {neg0} of {n_edge}, "
          f"+0.0 after stft in all; {negative} of those bins with a negative"
          f" real part, phase equal to the CPU's in all; max |S_card - "
          f"S_cpu| / max |S| {rel:.3e}", flush=True)

    k6 = {}
    for m in K6_20_M:
        line, plan = vq_plan_line(torch, vq, m, NQ20)
        print(line, flush=True)
        share, worst, ms, plain_ms, n_rec = check_vq(torch, vq, m, NQ20,
                                                     ("K6",))["K6"]
        k6[m] = (share, worst, ms, plain_ms, n_rec)
        b_ms, _ = vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"], NQ20)
        print(f"K6 at M={m}, N=1024, D=512, nq={NQ20}: {share:.5f} of codes "
              f"equal to plain, worst distance excess {worst:.3e}; kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us (3xTF32 at 495 TFLOP/s); L2 bytes "
              f"{plan['l2_bytes'][NQ20]} | {gpu}", flush=True)

    def roundtrip():
        return tok.detokenize(*tok.tokenize(x))

    wall, lo, hi = median_wall(torch, roundtrip, 10)
    print(f"hcodec20 round trip rtfx {CLIP_S / wall:.2f} (median of 10: "
          f"{wall * 1e3:.2f} ms for {CLIP_S:.0f} s of 48 kHz audio; range "
          f"{lo * 1e3:.2f}-{hi * 1e3:.2f} ms) | {gpu}", flush=True)

    # benchmarks/bench_hcodec20.py: encode + decode of a batch with random
    # HuBERT-shaped features (no frontend), rtfx = batch x seconds / p50
    b, secs = BENCH20["batch"], BENCH20["seconds"]
    t = int(secs * SR20) // tok.hop_length * tok.hop_length
    g = torch.Generator(device="cuda").manual_seed(0)
    bwav = torch.randn(b, t, 1, generator=g, device="cuda")
    feat = torch.randn(b, t // 3 // 320, tok.config.feat_dim, generator=g,
                       device="cuda")
    codec = tok.codec

    def batch_roundtrip():
        with torch.no_grad():
            return codec.decode(*codec.encode(bwav, feat))

    wall, lo, hi = median_wall(torch, batch_roundtrip, 5)
    print(f"hcodec20 bench_hcodec20 configuration (batch {b} x {t} samples,"
          f" K6 at M={b * (t // tok.hop_length)}): rtfx {b * secs / wall:.2f}"
          f" (median of 5: {wall * 1e3:.2f} ms; range {lo * 1e3:.2f}-"
          f"{hi * 1e3:.2f} ms) | {gpu}", flush=True)

    # the round trip with the plain VQ, outside the guards
    with patched([(vq, "rvq_encode_fused", vq.rvq_encode_fused_ref)]):
        plain_codes = tok.tokenize(x)
    same = float(np.mean([float((a == b_).float().mean())
                          for a, b_ in zip(plain_codes, codes)]))
    if same < 0.999:
        fail(f"HCodec-2.0 plain-VQ round trip: {same:.5f} of codes equal")
    print(f"hcodec20 round trip with plain VQ: {same:.5f} of codes equal",
          flush=True)
    return k6_launches, k6


# ---------------------------------------------------------------------------
# UniTok-audio served from the paged pool in the stream mode
# ---------------------------------------------------------------------------

def unitok_requests(torch, tok, rng, n):
    """``n`` requests cycling through the 7 tasks on 5-s synthetic inputs
    (250 HuBERT frames, 125 codec frames): VC and TSE carry a 2-s
    reference's features, LASS 20 frames of random caption features (there
    is no text encoder); odd ones are sampled."""
    from unified_audio_tpu_torch.models.unitok.model import UNITOK_TASKS
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokRequest

    def clips(secs, level):
        m = int(secs * SR)
        x = np.stack([level * synth_speech(rng, m)
                      + 0.05 * rng.standard_normal(m) for _ in range(n)])
        return torch.as_tensor(x.astype(np.float32), device="cuda")

    wavs, refs = clips(5.0, 0.5), clips(2.0, 0.4)
    feats = tok.extract_features(tok.pad_wav(wavs)).cpu().numpy()
    ref_feats = tok.extract_features(refs).cpu().numpy()
    frames = wavs.shape[1] // tok.hop_length
    tasks = list(UNITOK_TASKS)
    reqs = []
    for i in range(n):
        task = tasks[i % len(tasks)]
        reqs.append(UniTokRequest(
            task_id=UNITOK_TASKS[task], num_frames=frames,
            input_feats=feats[i],
            ref_feats=ref_feats[i] if task in ("tse", "vc") else None,
            caption_feats=(rng.standard_normal((20, 768)).astype(np.float32)
                           if task == "lass" else None),
            do_sample=i % 2 == 1, uid=i))
    return reqs


def check_codes(results, reqs, k):
    for r in reqs:
        c = results[r.uid].codes
        if c.shape != (r.num_frames, k) or not (0 <= c.min()
                                                and c.max() < 1024):
            fail(f"UniTok request {r.uid}: codes of shape {c.shape} in "
                 f"[{c.min()}, {c.max()}]")


def unitok_agreement(torch, lm, reqs, quant, steps=24):
    """Teacher-forced decode of two same-signature UniTok requests in fp32
    through the stream kernels and through the plain attention: max
    |logit diff| over ``steps`` steps."""
    from unified_audio_tpu_torch.models.unitok.model import delay_window_masks
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokEngine

    engines = {mode: UniTokEngine(lm, num_slots=2, use_kernel=mode,
                                  kv_quant=quant) for mode in ("stream", "")}
    for eng in engines.values():
        eng.admit_wave(reqs)
    code_mask, _ = delay_window_masks(lm.cfg, "cuda")
    ids = torch.full((2, lm.cfg.num_codebooks), lm.cfg.bos, dtype=torch.int32,
                     device="cuda")
    worst = 0.0
    for _ in range(steps):
        logits = {}
        for mode, eng in engines.items():
            logits[mode] = eng.decode_logits(ids)
            eng.state["index"] += 1
        worst = max(worst, (logits["stream"] - logits[""]).abs().max().item())
        ids = (logits[""] + code_mask).argmax(-1).int()
    return worst


def unitok_phase(torch, cli, pa, paged, tok, unise, gpu, tally):
    """Phase 5 -> (K3 launches, K4 launches) on their serving passes; the
    K7 check's launches go to ``tally``."""
    from unified_audio_tpu_torch.models.unitok.model import UniTokConfig, UniTokLM
    from unified_audio_tpu_torch.models.unitok.pipeline import UniTokPipeline
    from unified_audio_tpu_torch.serve.engine import Request
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokEngine
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = UniTokConfig()
    with torch.device("cuda"):
        lm = UniTokLM(cfg)
    init_random_(lm, torch.Generator(device="cuda").manual_seed(3)).eval()
    pipe = UniTokPipeline(tok, lm.to(torch.bfloat16))
    k = cfg.num_codebooks
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain attention path ran during serving")

    guards = [(paged, "_plain_attention", forbidden),
              (pa, "paged_flash_decode_stream_flat_ref", forbidden),
              (pa, "paged_flash_decode_stream_flat_q8_ref", forbidden)]

    # int8 pool, K4: 24 requests over the 7 tasks through 16 slots
    reqs = unitok_requests(torch, tok, rng, 24)
    eng = UniTokEngine(lm, num_slots=16, use_kernel="stream", kv_quant="int8")
    bounds = []
    block_bound = eng._block_bound

    def recorded_bound():
        bounds.append(block_bound())
        return bounds[-1]

    with patched(guards + [(eng, "_block_bound", recorded_bound)]):
        pa.paged_flash_decode_stream_flat_q8.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run(reqs, gen)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        k4 = pa.paged_flash_decode_stream_flat_q8.launches
    st = eng.stats()
    if k4 != L * st["decode_steps"] or st["decode_steps"] == 0:
        fail(f"K4 launched {k4} times for {st['decode_steps']} decode steps "
             f"of {L} layers")
    if not all(b % 64 == 0 and 64 <= b <= eng.num_blocks for b in bounds):
        fail(f"decode bounds {sorted(set(bounds))} not 64-block buckets "
             f"within the pool's {eng.num_blocks} blocks")
    check_codes(results, reqs, k)
    codes = torch.as_tensor(np.stack([results[r.uid].codes for r in reqs]),
                            device="cuda").long()
    wav = pipe.codes_to_audio(codes)
    n_out = reqs[0].num_frames * tok.hop_length
    if wav.shape != (len(reqs), n_out) or not bool(torch.isfinite(wav).all()):
        fail(f"UniTok waveforms of shape {tuple(wav.shape)}, finite "
             f"{bool(torch.isfinite(wav).all())}")
    n_codes = k * sum(r.num_frames for r in reqs)
    print(f"unitok int8 pool (stream, K4): {len(reqs)} requests over 7 tasks,"
          f" codes {tuple(results[0].codes.shape)} each, {st['decode_steps']}"
          f" decode steps, {st['prefill_waves']} prefill waves, bounds "
          f"{min(bounds)}-{max(bounds)} of {eng.num_blocks} blocks; engine "
          f"{engine_s:.2f} s = {n_codes / engine_s:.0f} codes/s "
          f"({n_codes / k / engine_s:.0f} frames/s); K4 launches {k4}; "
          f"waveforms {tuple(wav.shape)} finite | {gpu}", flush=True)

    # one bf16 pool and one allocator shared by UniSE and UniTok, K3
    unise.sft.to(torch.bfloat16)
    nb = 320
    pool_ref = paged.PoolRef(paged.init_pool(cfg.llama_config, nb, 64,
                                             dtype=torch.bfloat16,
                                             device="cuda"))
    alloc = paged.BlockAllocator(nb)
    eng_u = cli.make_engine(unise, 4, use_kernel="stream", pool_ref=pool_ref,
                            allocator=alloc)
    eng_t = UniTokEngine(lm, num_slots=4, use_kernel="stream",
                         pool_ref=pool_ref, allocator=alloc)
    seg = unise.config.segment_len
    sem_len = unise._semantic_len()
    u_reqs = [Request(task_id=i % 2, mix_wav=(0.5 * synth_speech(rng, seg)
                                              ).astype(np.float32),
                      enroll_wav=((0.4 * synth_speech(rng, seg)).astype(
                          np.float32) if i % 2 else None),
                      semantic_length=sem_len, do_sample=i >= 2, uid=100 + i)
              for i in range(4)]
    # the pass-1 requests without a reference or caption: one signature
    t_reqs = [dataclasses.replace(r, uid=200 + r.uid) for r in reqs
              if r.ref_feats is None and r.caption_feats is None][:4]
    with patched(guards):
        if len(eng_u.admit_many(u_reqs)) != 4 or \
                len(eng_t.admit_wave(t_reqs)) != 4:
            fail("the shared pool did not admit 4 + 4 requests")
        held_u = {b for bl in eng_u._slot_blocks for b in bl}
        held_t = {b for bl in eng_t._slot_blocks for b in bl}
        if not held_u or not held_t or held_u & held_t:
            fail(f"shared pool blocks overlap: {sorted(held_u & held_t)}")
        pa.paged_flash_decode_stream_flat.launches = 0
        res_u, res_t = {}, {}
        check_s = None
        t0 = time.perf_counter()
        while len(res_u) < len(u_reqs) or len(res_t) < len(t_reqs):
            for e, res, n in ((eng_u, res_u, len(u_reqs)),
                              (eng_t, res_t, len(t_reqs))):
                if len(res) < n:
                    e.step(gen)
                    res.update({r.uid: r for r in e.harvest()})
            if check_s is None:  # K7 on the tables the two engines hold
                t1 = time.perf_counter()
                with uncounted(tally, pa.paged_flash_decode,
                               pa.paged_flash_decode_stream_flat):
                    errs = [table_on_live_pool(torch, pa, paged, e, "K3")
                            for e in (eng_u, eng_t)]
                check_s = time.perf_counter() - t1
        shared_s = time.perf_counter() - t0 - check_s
        k3 = pa.paged_flash_decode_stream_flat.launches
    steps_u = eng_u.stats()["decode_steps"]
    steps_t = eng_t.stats()["decode_steps"]
    if k3 != L * (steps_u + steps_t):
        fail(f"K3 launched {k3} times for {steps_u} + {steps_t} decode "
             f"steps of {L} layers")
    for r in res_u.values():
        if r.global_ids.shape != (32,) or r.semantic_ids.shape != (sem_len,) \
                or not (0 <= r.global_ids.min() and r.global_ids.max() < 4096
                        and 0 <= r.semantic_ids.min()
                        and r.semantic_ids.max() < 8192):
            fail(f"shared pool UniSE result {r.uid} out of range")
    check_codes(res_t, t_reqs, k)
    if len(alloc.free) != nb - 1:
        fail(f"shared pool leaked blocks: {nb - 1 - len(alloc.free)} held")
    print(f"shared bf16 pool (stream, K3): UniSE {len(u_reqs)} segments in "
          f"{steps_u} steps and UniTok {len(t_reqs)} requests in {steps_t} "
          f"steps, stepped in turn, {len(held_u)} + {len(held_t)} disjoint "
          f"blocks; {shared_s:.2f} s; K3 launches {k3} | {gpu}", flush=True)
    print(f"K7 on the shared bf16 pool after the first steps, every layer, "
          f"vs K3 on the mask the tables give: UniSE engine max abs err "
          f"{errs[0]:.3e}, UniTok engine {errs[1]:.3e}", flush=True)

    # teacher-forced fp32: the stream kernels against the plain attention
    lm.float()
    two = [r for r in reqs if r.task_id == 0][:2]
    for quant in (None, "int8"):
        worst = unitok_agreement(torch, lm, two, quant)
        print(f"teacher-forced fp32 UniTok decode, {quant or 'fp32'} pool: "
              f"stream kernels vs plain attention max |logit diff| "
              f"{worst:.2e}", flush=True)
        if not worst <= 1e-4:
            fail(f"stream-kernel decode disagrees with the plain path: "
                 f"{worst}")
    return k3, k4


# ---------------------------------------------------------------------------
# UniSE SFT training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 30  # steps of the training run (batch 32 x 5 s)
RESUME_STEPS = 3  # steps of the resumed run
TIMED_FROM = 5  # the median step time is over steps TIMED_FROM..TRAIN_STEPS
PROFILED_STEP = 20  # the step traced for the device's busy share
BATCH = 32


def write_train_data(tmp, rng, write_wav):
    """Synthetic SCP lists: 4 speakers x 3 utterances of 6 s (speech-like
    tones), a 12-s noise and a 0.4-s exponentially decaying RIR."""
    lines = []
    for spk in range(4):
        for u in range(3):
            path = tmp / f"spk{spk}_{u}.wav"
            write_wav(path, (0.5 * synth_speech(rng, 6 * SR)).astype(
                np.float32), SR)
            lines.append(f"spk{spk}_u{u} spk{spk} {path}")
    (tmp / "speech.scp").write_text("\n".join(lines) + "\n")
    noise = np.cumsum(rng.standard_normal(12 * SR)) * 0.01
    noise -= np.convolve(noise, np.ones(400) / 400, mode="same")
    write_wav(tmp / "noise.wav", (0.3 * noise / np.abs(noise).max()).astype(
        np.float32), SR)
    (tmp / "noise.scp").write_text(f"n0 {SR} 0 {12 * SR} {tmp / 'noise.wav'}\n")
    n = int(0.4 * SR)
    rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (0.05 * SR))
    rir[0] = 1.0
    write_wav(tmp / "rir.wav", (0.9 * rir / np.abs(rir).max()).astype(
        np.float32), SR)
    (tmp / "rir.scp").write_text(f"r0 {tmp / 'rir.wav'}\n")
    return {k: [str(tmp / f"{k}.scp")] for k in ("speech", "noise", "rir")}


def train_config(tmp, scps, steps, name):
    """configs/unise.yaml with the SCP paths, the run's length, a 5-step
    warmup, validation and the checkpoint directory changed (printed)."""
    from unified_audio_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(REPO / "configs" / "unise.yaml")
    changes = {f"dataset.{k}_scp": v for k, v in scps.items()}
    changes.update({"dataset.samples_per_epoch": steps * BATCH,
                    "max_epochs": 1, "opt.warmup_steps": 5,
                    "val_every": 15, "val_batches": 2,
                    "ckpt_dir": str(tmp / "ckpt")})
    for key, value in changes.items():
        node = cfg
        *parents, leaf = key.split(".")
        for k in parents:
            node = node[k]
        node[leaf] = value
    cfg["val_dataset"] = dict(cfg["dataset"])
    print(f"train config {name}: configs/unise.yaml with "
          f"{json.dumps(changes)}, val_dataset = dataset", flush=True)
    path = tmp / f"{name}.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return path


class StepRecorder:
    """Wraps the trainer's phases for one run: each step's loss, accuracy,
    rate and wall time (``train_step`` ends in a host sync), the host's
    wait between steps (the data and the logging), the device time of the
    frozen inputs, the LM's forward + backward and the update (CUDA events),
    and a torch.profiler trace of step ``profile_at``."""

    def __init__(self, torch, trainer_cls, unise_cls, profile_at=None):
        self.torch, self.profile_at = torch, profile_at
        self.steps, self.trainer, self.targets = [], None, None
        self._last_end = None
        self._events = {}
        outer = self
        train_step = trainer_cls.train_step
        phases = [(unise_cls, "frozen_inputs"),
                  (trainer_cls, "loss_backward"), (trainer_cls, "update")]

        def timed(name, fn):
            def wrapper(*args, **kw):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kw)
                b.record()
                outer._events[name] = (a, b)
                if name == "frozen_inputs":  # G + T + 2 targets a segment
                    outer.targets = out[2].shape[1] + out[3].shape[1] + 2
                return out
            return wrapper

        def step(trainer, task, *args):
            outer.trainer = trainer
            start = time.perf_counter()
            wait = (None if outer._last_end is None
                    else start - outer._last_end)
            lr = trainer.optimizer.lr
            prof = None
            if trainer.step + 1 == outer.profile_at:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            loss, acc = train_step(trainer, task, *args)
            end = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
                outer.busy = busy_share(torch, prof, end - start)
            outer.steps.append(dict(
                step=trainer.step, task=task, loss=loss, acc=acc, lr=lr,
                wall_s=end - start, wait_s=wait,
                **{f"{k}_ms": a.elapsed_time(b)
                   for k, (a, b) in outer._events.items()}))
            outer._last_end = end
            return loss, acc

        self.patches = [(trainer_cls, "train_step", step)] + [
            (cls, name, timed(name, getattr(cls, name)))
            for cls, name in phases]


def busy_share(torch, prof, wall_s):
    """-> (the share of ``wall_s`` in which the card ran a kernel or a
    copy, the device records' count): the union of their intervals."""
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6 / wall_s, len(spans)


def train_phase(torch, cli, pa, gpu, tmp, write_wav, read_wav):
    """Phase 7: UniSE's SFT training through ``cli train-unise`` at full
    width on the card; the card against the CPU on one batch; a resume; the
    step-30 checkpoint served through K2."""
    import contextlib
    import io
    from collections import Counter

    from unified_audio_tpu_torch.models.unise.model import UniSE
    from unified_audio_tpu_torch.train.optim import warmup_exp_decay_schedule
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer

    rng = np.random.default_rng(9)
    scps = write_train_data(tmp, rng, write_wav)
    rec = StepRecorder(torch, SFTTrainer, UniSE, profile_at=PROFILED_STEP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(rec.patches):
        trainer = cli.main(["train-unise", "--config", str(train_config(
            tmp, scps, TRAIN_STEPS, "train"))])
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = rec.steps
    if [r["step"] for r in steps] != list(range(1, TRAIN_STEPS + 1)):
        fail(f"trained steps {[r['step'] for r in steps]}")
    losses = [r["loss"] for r in steps]
    if not np.isfinite(losses).all():
        fail(f"a training loss is not finite: {losses}")
    ckpt_dir = tmp / "ckpt"
    records = [json.loads(l) for l in
               (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    val = {r["step"]: r["valid_loss"] for r in records if "valid_loss" in r}
    if sorted(val) != [15, 30] or not val[30] < val[15]:
        fail(f"validation loss {val}: it must fall from step 15 to step 30")
    ckpt30 = ckpt_dir / "step_00000030.pt"
    if not ckpt30.exists():
        fail("no checkpoint at step 30")
    timed_steps = [r for r in steps if r["step"] >= TIMED_FROM]
    step_ms = 1e3 * float(np.median([r["wall_s"] for r in timed_steps]))
    print(f"train-unise: {TRAIN_STEPS} steps of {BATCH} x 5 s at full width "
          f"(LM 512 x 12, XLSR-53 24 x 1024, WavLM-base-plus, BiCodec "
          f"encoder and speaker encoder; fp32, TF32 off) in {run_s:.1f} s; "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, all finite (by "
          f"step: {[round(x, 2) for x in losses]}); tasks "
          f"{dict(Counter(r['task'] for r in steps))}; validation loss "
          f"{val[15]:.4f} at step 15 -> {val[30]:.4f} at step 30 | {gpu}",
          flush=True)
    parts = {k: float(np.median([r[f"{k}_ms"] for r in timed_steps]))
             for k in ("frozen_inputs", "loss_backward", "update")}
    wait_ms = 1e3 * float(np.median([r["wait_s"] for r in timed_steps]))
    busy, n_records = rec.busy
    print(f"train step (median of steps {TIMED_FROM}-{TRAIN_STEPS}): wall "
          f"{step_ms:.1f} ms = {BATCH * rec.targets / step_ms * 1e3:.0f} "
          f"training tokens/s ({BATCH} x {rec.targets} targets a step); "
          f"device "
          f"time: tokenize + features (frozen) "
          f"{parts['frozen_inputs']:.1f} ms, LM forward + backward "
          f"{parts['loss_backward']:.1f} ms, optimizer {parts['update']:.1f} "
          f"ms; host data wait between steps {wait_ms:.1f} ms; device busy "
          f"{100 * busy:.1f}% of profiled step {PROFILED_STEP} "
          f"({n_records} CUDA records); peak memory allocated "
          f"{peak_gb:.2f} GB | {gpu}", flush=True)

    agreement(torch, cli, trainer, gpu)

    # resume: a few more steps on the same ckpt_dir
    rec2 = StepRecorder(torch, SFTTrainer, UniSE)
    err = io.StringIO()
    with patched(rec2.patches), contextlib.redirect_stderr(err):
        resumed = cli.main(["train-unise", "--config", str(train_config(
            tmp, scps, RESUME_STEPS, "resume"))])
    sys.stderr.write(err.getvalue())
    want_lr = warmup_exp_decay_schedule(warmup_steps=5)(TRAIN_STEPS)
    first = rec2.steps[0]
    if "resumed from step 30" not in err.getvalue() or first["step"] != 31 \
            or first["lr"] != want_lr or resumed.step != 33:
        fail(f"resume: first step {first['step']} at lr {first['lr']}, "
             f"schedule(30) = {want_lr}; stderr {err.getvalue()!r}")
    print(f"resumed at step 30: steps 31-{resumed.step}, first lr "
          f"{first['lr']:.9g} = schedule(30), losses "
          f"{[round(r['loss'], 4) for r in rec2.steps]}", flush=True)
    del trainer, resumed
    torch.cuda.empty_cache()

    # the step-30 checkpoint served through K2
    path, lines = write_requests(tmp, rng, write_wav,
                                 [("tse", 10.0, False)], "trained")
    pa.paged_flash_decode_owner_q8.launches = 0
    summary = cli.main(["serve", "--requests", str(path), "--kv-quant",
                        "int8", "--ckpt", str(ckpt30)])
    k2 = pa.paged_flash_decode_owner_q8.launches
    out, fs = read_wav(lines[0]["output"])
    st = summary["engine_stats"]
    if summary["segments"] != 2 or k2 < L * st["decode_steps"] or \
            out.shape != (1, 10 * SR) or not np.isfinite(out).all():
        fail(f"serving the trained checkpoint: {summary['segments']} "
             f"segments, K2 launches {k2}, output {out.shape}")
    print(f"serve --ckpt step 30 --kv-quant int8: 2 segments, "
          f"{st['decode_steps']} decode steps, K2 launches {k2}, output "
          f"{out.shape} finite | {gpu}", flush=True)


def agreement(torch, cli, trainer, gpu):
    """One TSE batch of 2 segments from a seed through the trained stack
    on the card and a CPU copy of it: tokens equal in >= 99.9% of places,
    the loss within 1e-4 relative, each LM gradient within 1e-3 of its
    largest entry."""
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer

    gpu_u = trainer.unise
    cpu_u = cli._build_unise(device="cpu", tokenize=True)
    for name in ("sft", "wavlm"):
        getattr(cpu_u, name).load_state_dict(getattr(gpu_u, name).state_dict())
    cpu_u.tokenizer.model.load_state_dict(gpu_u.tokenizer.model.state_dict())
    cpu_u.tokenizer.ssl.load_state_dict(gpu_u.tokenizer.ssl.state_dict())
    rng = np.random.default_rng(11)
    wavs = [np.stack([0.5 * synth_speech(rng, 5 * SR) + 0.05 *
                      rng.standard_normal(5 * SR) for _ in range(2)]).astype(
        np.float32) for _ in range(3)]
    out = []
    for u in (gpu_u, cpu_u):
        t = SFTTrainer(u)
        dev = t.device()
        frozen = u.frozen_inputs(*(torch.as_tensor(w, device=dev)
                                   for w in wavs))
        loss, _ = t.loss_backward("tse", frozen)
        out.append((frozen[2].cpu(), frozen[3].cpu(), loss.item(),
                    {k: p.grad.cpu() for k, p in u.sft.named_parameters()}))
        u.sft.zero_grad()
    (gg, gs, gl, ggrad), (cg, cs, cl, cgrad) = out
    same = torch.cat([(gg == cg).flatten(), (gs == cs).flatten()])
    share = same.float().mean().item()
    rel = abs(gl - cl) / abs(cl)
    grad_err = max(((ggrad[k] - g).abs().max() / g.abs().max()).item()
                   for k, g in cgrad.items())
    print(f"card vs CPU, one TSE batch of 2 x 5 s through the trained stack: "
          f"tokens equal {share:.5f} ({int(same.sum())} of {same.numel()}), "
          f"loss {gl:.9g} vs {cl:.9g} (rel {rel:.2e}), LM gradients max "
          f"|diff| / max |grad| {grad_err:.2e} | {gpu}", flush=True)
    if share < 0.999 or rel > 1e-4 or grad_err > 1e-3:
        fail("the card's training step disagrees with the CPU's")
    del cpu_u


# ---------------------------------------------------------------------------
# HCodec-1.0 GAN training
# ---------------------------------------------------------------------------

CODEC_STEPS = 30  # steps of the codec training run
CODEC_ADV_FROM = 10  # perceptual_start_step: steps 11-30 run the GAN terms
CODEC_BATCH, CODEC_SEG = 8, 48000  # configs/hcodec10.yaml: 8 x 3 s
CODEC_PROFILED_STEP = 20  # an adversarial step, traced for the busy share
# K5 launches the run implies: each of the 2 x 4 layers searches once a
# step, and on the first step its k-means searches 50 times plus once for
# the final bins
CODEC_K5 = 8 * CODEC_STEPS + 8 * (50 + 1)


def write_domain_data(tmp, rng, write_wav):
    """Synthetic domain SCP lists: 6 speech-like tone wavs ("speech") and 6
    band-limited noise wavs ("audio"), 4 s each at 16 kHz."""
    scps = {}
    for domain in ("speech", "audio"):
        lines = []
        for i in range(6):
            n = 4 * SR
            if domain == "speech":
                x = 0.5 * synth_speech(rng, n)
            else:
                x = np.convolve(rng.standard_normal(n), np.ones(8) / 8,
                                mode="same")
                x = 0.3 * x / np.abs(x).max()
            path = tmp / f"{domain}{i}.wav"
            write_wav(path, x.astype(np.float32), SR)
            lines.append(f"{domain}{i} s{i} {path}")
        (tmp / f"{domain}.scp").write_text("\n".join(lines) + "\n")
        scps[domain] = [str(tmp / f"{domain}.scp")]
    return scps


def codec_train_config(tmp, scps):
    """configs/hcodec10.yaml with the synthetic domains as its dataset, 30
    steps, the GAN terms from step 10 and the checkpoint directory in
    ``tmp`` (printed)."""
    from unified_audio_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(REPO / "configs" / "hcodec10.yaml")
    changes = {"dataset": {"domain_scps": scps}, "max_steps": CODEC_STEPS,
               "train.perceptual_start_step": CODEC_ADV_FROM,
               "ckpt_dir": str(tmp / "codec_ckpt")}
    for key, value in changes.items():
        node = cfg
        *parents, leaf = key.split(".")
        for k in parents:
            node = node[k]
        node[leaf] = value
    print(f"train config codec: configs/hcodec10.yaml with "
          f"{json.dumps(changes)}", flush=True)
    path = tmp / "codec.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    return path


class CodecStepRecorder:
    """Wraps codec training for one run: each step's metrics, domain and
    wall time (``train_step`` ends in one host read), the device time (CUDA
    events)
    of the HuBERT features, the generator's forward + backward, the
    discriminator's and each side's update, a torch.profiler trace of step
    ``profile_at``, the codebooks' state after step 1 and the first layer's
    k-means rows and initial codebook."""

    def __init__(self, torch, modules, profile_at):
        trainer_cls, optim_cls, ssl_cls, quant, data_cls = modules
        self.torch, self.profile_at = torch, profile_at
        self.steps, self.after_first, self.kmeans0 = [], None, None
        self.domains = []  # each batch's domain, in the order of the steps
        self._events, self._last_end = {}, None
        outer = self

        def timed(name, fn):
            def wrapper(self_, *args, **kw):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(self_, *args, **kw)
                b.record()
                key = name
                if name == "update":
                    key = ("gen_update" if self_ is outer.trainer.gen_opt
                           else "disc_update")
                outer._events[key] = (a, b)
                return out
            return wrapper

        train_step = trainer_cls.train_step
        outer.trainer = None

        def step(trainer, wav, feat):
            outer.trainer = trainer
            start = time.perf_counter()
            wait = None if outer._last_end is None else start - outer._last_end
            prof = None
            if trainer.step + 1 == outer.profile_at:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            outer._events.pop("disc_step", None)
            metrics = train_step(trainer, wav, feat)
            end = time.perf_counter()
            if prof is not None:
                prof.__exit__(None, None, None)
                outer.busy = busy_share(torch, prof, end - start)
            ms = {f"{k}_ms": a.elapsed_time(b)
                  for k, (a, b) in outer._events.items()}
            outer.steps.append(dict(step=trainer.step, wall_s=end - start,
                                    wait_s=wait, **metrics, **ms))
            if trainer.step == 1:
                outer.after_first = [
                    (q._codebook.initted.item(),
                     q._codebook.cluster_size.sum().item())
                    for rvq in (trainer.codec.quantizer,
                                trainer.codec.semantic_quantizer)
                    for q in rvq.layers]
            outer._last_end = end
            return metrics

        sample_vectors = quant.sample_vectors

        def recording_rows(samples, num, generator=None):
            out = sample_vectors(samples, num, generator)
            if outer.kmeans0 is None:
                outer.kmeans0 = (samples.clone(), out.clone())
            return out

        batches = data_cls._batches

        def recording_batches(self_):
            for wav, domain in batches(self_):
                outer.domains.append(domain)
                yield wav, domain

        self.patches = [
            (data_cls, "_batches", recording_batches),
            (trainer_cls, "train_step", step),
            (trainer_cls, "generator_step",
             timed("gen_step", trainer_cls.generator_step)),
            (trainer_cls, "discriminator_step",
             timed("disc_step", trainer_cls.discriminator_step)),
            (optim_cls, "step", timed("update", optim_cls.step)),
            (ssl_cls, "forward", timed("hubert", ssl_cls.forward)),
            (quant, "sample_vectors", recording_rows)]


def codec_train_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Phase 8: HCodec-1.0 GAN training through ``cli train-codec`` at full
    width on the card, the plain search made to raise; the card against
    the CPU on one step; K5 on k-means' duplicated codebook; the final
    checkpoint through ``cli codec --ckpt`` -> (K5's launches on the
    training path, K6's in that round trip, K5's times on k-means' start
    for the kernels line)."""
    from unified_audio_tpu_torch.data.hcodec_data import DomainWeightedIterator
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import Wav2Vec2Model
    from unified_audio_tpu_torch.ops import quant
    from unified_audio_tpu_torch.train.codec_trainer import CodecGANTrainer
    from unified_audio_tpu_torch.train.optim import Optimizer

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in codec training")

    rng = np.random.default_rng(13)
    config = codec_train_config(tmp, write_domain_data(tmp, rng, write_wav))
    rec = CodecStepRecorder(torch, (CodecGANTrainer, Optimizer,
                                    Wav2Vec2Model, quant,
                                    DomainWeightedIterator),
                            CODEC_PROFILED_STEP)
    guards = rec.patches + [(vq, "nearest_code_ref", forbidden),
                            (vq, "rvq_encode_fused_ref", forbidden)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' tensors
    vq.nearest_code.launches = 0
    t0 = time.perf_counter()
    with patched(guards):
        trainer = cli.main(["train-codec", "--config", str(config)])
    run_s = time.perf_counter() - t0
    k5 = vq.nearest_code.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    steps = rec.steps
    if [r["step"] for r in steps] != list(range(1, CODEC_STEPS + 1)):
        fail(f"codec training steps {[r['step'] for r in steps]}")
    names = ("mel", "commit", "semantic", "adv", "fm", "gen_loss",
             "disc_loss")
    values = np.array([[r[k] for k in names] for r in steps])
    if not np.isfinite(values).all():
        fail(f"a codec training loss is not finite: {values.tolist()}")
    mel = values[:, 0]
    # a batch is one domain's, and the noise domain's mel loss is the
    # larger: steps 26-30 against steps 1-5 within each domain
    domains = np.array(rec.domains[:CODEC_STEPS])
    falls = {}
    for d in sorted(set(domains)):
        first, last = mel[:5][domains[:5] == d], mel[-5:][domains[-5:] == d]
        if len(first) and len(last):
            falls[d] = (float(first.mean()), float(last.mean()))
    if not falls or any(b >= a for a, b in falls.values()):
        fail(f"mel loss (mean of steps 1-5, of 26-30) by domain: {falls}")
    adv_on = [r["step"] for r in steps if r["adv"] != 0.0]
    if adv_on != list(range(CODEC_ADV_FROM + 1, CODEC_STEPS + 1)):
        fail(f"the GAN terms ran at steps {adv_on}")
    m = CODEC_BATCH * CODEC_SEG // 640  # rows a layer searches: 8 x 75
    first = rec.after_first
    if len(first) != 8 or any(i != 1.0 or abs(n - m) > 1e-3 * m
                              for i, n in first):
        fail(f"after step 1 (initted, sum of cluster sizes) per layer: "
             f"{first}; want (1, {m}) each")
    if k5 != CODEC_K5:
        fail(f"K5 launched {k5} times in codec training, not {CODEC_K5}")
    ckpt = tmp / "codec_ckpt" / f"step_{CODEC_STEPS:08d}.pt"
    if not ckpt.exists():
        fail(f"no codec checkpoint at step {CODEC_STEPS}")
    print(f"train-codec: {CODEC_STEPS} steps of HCodec-1.0 at full width "
          f"({CODEC_BATCH} x 3 s, MPD 2/3/5/7/11 + MS-STFT "
          f"1024/2048/512, HuBERT-base frozen; fp32, TF32 off) in "
          f"{run_s:.1f} s; mel loss (mean of steps 1-5 -> of 26-30) by "
          f"domain {json.dumps(falls)}; every loss finite; by step domain "
          f"{''.join(d[0] for d in domains)}, mel "
          f"{[round(float(x), 3) for x in mel]}, gen "
          f"{[round(r['gen_loss'], 3) for r in steps]}, disc "
          f"{[round(r['disc_loss'], 3) for r in steps]}; after step 1 all 8 "
          f"layers initted, cluster sizes summing to "
          f"{[round(n, 3) for _, n in first]} (M = {m}); K5 launches {k5} "
          f"= {CODEC_K5} (8 a step + 8 x 51 for k-means), the plain search "
          f"unused | {gpu}", flush=True)

    timed_steps = [r for r in steps if r["step"] >= TIMED_FROM]
    step_ms = 1e3 * float(np.median([r["wall_s"] for r in timed_steps]))
    adv = [r for r in steps if r["step"] > CODEC_ADV_FROM]
    pre = [r for r in steps if TIMED_FROM <= r["step"] <= CODEC_ADV_FROM]
    med = lambda rows, k: float(np.median([r[k] for r in rows]))
    wait_ms = 1e3 * med(timed_steps, "wait_s")
    gen_fb = [r["gen_step_ms"] - r["gen_update_ms"] for r in adv]
    disc_fb = [r["disc_step_ms"] - r["disc_update_ms"] for r in adv]
    busy, n_records = rec.busy
    print(f"codec train step (median of steps {TIMED_FROM}-{CODEC_STEPS}): "
          f"wall {step_ms:.1f} ms = "
          f"{CODEC_BATCH * CODEC_SEG / SR / step_ms * 1e3:.1f} audio seconds"
          f" trained a second ({CODEC_BATCH} x 3 s a step); device time "
          f"(medians of the adversarial steps {CODEC_ADV_FROM + 1}-"
          f"{CODEC_STEPS}): HuBERT features {med(adv, 'hubert_ms'):.1f} ms, "
          f"generator forward + backward {float(np.median(gen_fb)):.1f} ms "
          f"({med(pre, 'gen_step_ms') - med(pre, 'gen_update_ms'):.1f} ms "
          f"before step {CODEC_ADV_FROM + 1}, without the GAN terms), "
          f"discriminator forward + backward {float(np.median(disc_fb)):.1f}"
          f" ms, generator update {med(adv, 'gen_update_ms'):.1f} ms, "
          f"discriminator update {med(adv, 'disc_update_ms'):.1f} ms; host "
          f"between steps {wait_ms:.1f} ms; device busy {100 * busy:.1f}% "
          f"of profiled step {CODEC_PROFILED_STEP} ({n_records} CUDA "
          f"records); peak memory allocated by the run {peak_gb:.2f} GB "
          f"(beside {held_gb:.2f} GB the earlier phases hold) | {gpu}",
          flush=True)

    codec_agreement(torch, vq, quant, trainer, gpu)

    # K5 on the first layer's k-means start: M = 600 rows against 1024 rows
    # drawn from them with replacement (duplicates in different CTAs)
    samples, init = (t.contiguous() for t in rec.kmeans0)
    got = vq.nearest_code(samples, init)
    want = vq.nearest_code_ref(samples, init)
    dups = init.shape[0] - torch.unique(init, dim=0).shape[0]
    if samples.shape[0] != m or not torch.equal(got, want):
        fail(f"K5 on k-means' initial codebook: {samples.shape[0]} rows, "
             f"codes equal {float((got == want).float().mean()):.5f}")
    plain, kern = in_turns(torch, [lambda: vq.nearest_code_ref(samples, init),
                                   lambda: vq.nearest_code(samples, init)],
                           iters=50, kernels=[None, CUDA_KERNELS["vq"]])
    b_ms, _ = vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"], 1)
    print(f"K5 on k-means' initial codebook at M={m}, N=1024, D=512 "
          f"({dups} duplicate rows): codes equal to plain exactly; kernel "
          f"{kern['ms'] * 1e3:.2f} us, plain {plain['ms'] * 1e3:.2f} us, "
          f"bound {b_ms * 1e3:.2f} us (3xTF32 at 495 TFLOP/s) | {gpu}",
          flush=True)

    # the final checkpoint served by the round trip through K6
    n = int(CLIP_S * SR)
    wav = 0.5 * synth_speech(rng, n) + 0.05 * rng.standard_normal(n)
    wav_in, wav_out = tmp / "codec_in.wav", tmp / "codec_out.wav"
    write_wav(wav_in, (0.8 * wav / np.abs(wav).max()).astype(np.float32), SR)
    from unified_audio_tpu_torch.models.hcodec.codec import HCodec
    codes = []
    encode = HCodec.encode

    def recording(self, w, f):
        codes.append(encode(self, w, f))
        return codes[-1]

    vq.rvq_encode_fused.launches = 0
    with patched([(HCodec, "encode", recording),
                  (vq, "nearest_code_ref", forbidden),
                  (vq, "rvq_encode_fused_ref", forbidden)]):
        summary = cli.main(["codec", "--model", "hcodec10", "--input",
                            str(wav_in), "--output", str(wav_out),
                            "--ckpt", str(ckpt)])
    k6 = vq.rvq_encode_fused.launches
    out, fs = read_wav(wav_out)
    ranges = [(int(c.min()), int(c.max())) for c in codes[0]]
    if k6 != 2 or summary["acoustic_shape"] != [1, 4, 250] or not all(
            0 <= lo and hi < 1024 for lo, hi in ranges) or \
            out.shape != (1, n) or not np.isfinite(out).all():
        fail(f"codec --ckpt of the trained checkpoint: K6 launches {k6}, "
             f"codes {summary['acoustic_shape']} in {ranges}, output "
             f"{out.shape}")
    print(f"codec --ckpt step {CODEC_STEPS}: codes (1, 4, 250) a stream in "
          f"{ranges}, K6 launches {k6}, a finite output of {n} samples | "
          f"{gpu}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return k5, k6, {"max_abs_err": 0.0, "ms": kern["ms"],
                    "plain_ms": plain["ms"], "bound_ms": b_ms,
                    "records": kern["records"]}


def codec_agreement(torch, vq, quant, trainer, gpu):
    """One generator step (the GAN terms on) of the trained codec on 2 x 3 s
    from a seed, on the card and on a CPU copy of the codec and the
    discriminators, the same dropout cutoffs: the card's codes under
    ``judge_codes`` and equal to the CPU's in >= 99.9% of places, each loss
    within 1e-4 relative, each generator gradient within 1e-3 of its
    largest entry."""
    from unified_audio_tpu_torch.models.hcodec.codec import HCodec
    from unified_audio_tpu_torch.train.codec_trainer import CodecGANTrainer
    from unified_audio_tpu_torch.train.discriminators import (
        CodecDiscriminator)

    rng = np.random.default_rng(12)
    wav = np.stack([0.5 * synth_speech(rng, CODEC_SEG) + 0.05 *
                    rng.standard_normal(CODEC_SEG) for _ in range(2)])
    feat = 0.5 * rng.standard_normal((2, CODEC_SEG // 320, 768))
    codec_cpu = HCodec(trainer.codec.config, trainable=True)
    codec_cpu.load_state_dict(trainer.codec.state_dict())
    disc_cpu = CodecDiscriminator()
    disc_cpu.load_state_dict(trainer.disc.state_dict())
    out = []
    for codec, disc in ((trainer.codec, trainer.disc), (codec_cpu, disc_cpu)):
        dev = next(codec.parameters()).device
        searches = []
        search = quant.nearest_code

        def recording(x, codebook):
            codes = search(x, codebook)
            searches.append((x.detach().reshape(-1, x.shape[-1]),
                             codebook.clone(), codes.reshape(-1)))
            return codes

        t = CodecGANTrainer(codec, trainer.cfg, disc,
                            torch.Generator().manual_seed(5))
        codec.zero_grad(set_to_none=True)  # the last update's gradients
        with patched([(quant, "nearest_code", recording)]):
            loss, scalars, _ = t.generator_loss(
                torch.as_tensor(wav, dtype=torch.float32, device=dev),
                torch.as_tensor(feat, dtype=torch.float32, device=dev), True)
        loss.backward()
        out.append(({k: v.item() for k, v in scalars.items()},
                    {k: p.grad.cpu() for k, p in codec.named_parameters()},
                    searches))
        codec.zero_grad(set_to_none=True)
    (g_s, g_grad, g_codes), (c_s, c_grad, c_codes) = out
    worst, equal, total = 0.0, 0, 0
    for (x, cb, codes), (_, _, cpu) in zip(g_codes, c_codes):
        _, w, ok = vq.judge_codes(x, [cb], codes[:, None])
        if not ok:
            fail(f"a card code of the training step is no near tie: {w}")
        worst = max(worst, w)
        equal += int((codes.cpu() == cpu).sum())
        total += codes.numel()
    rel = max(abs(g_s[k] - c_s[k]) / max(abs(c_s[k]), 1e-30) for k in c_s)
    grad_err = max(((g_grad[k] - g).abs().max() / g.abs().max()).item()
                   for k, g in c_grad.items() if g.abs().max() > 0)
    print(f"card vs CPU, one generator step (GAN terms on) of the trained "
          f"codec on 2 x 3 s: {len(g_codes)} searches, codes equal "
          f"{equal / total:.5f} ({equal} of {total}), worst distance excess "
          f"{worst:.3e}; losses max rel diff {rel:.2e} (gen "
          f"{g_s['gen_loss']:.6f} vs {c_s['gen_loss']:.6f}); generator "
          f"gradients max |diff| / max |grad| {grad_err:.2e} | {gpu}",
          flush=True)
    if equal / total < 0.999 or rel > 1e-4 or grad_err > 1e-3:
        fail("the card's codec training step disagrees with the CPU's")


# ---------------------------------------------------------------------------
# The JAX CLI's remaining commands: enhance, codec --dtype bfloat16, eval
# ---------------------------------------------------------------------------

ENHANCE_S = 7.5  # cli enhance's clip: two 5-s segments
EVAL_PAIRS = 4  # cli eval's noisy/clean pairs of 5 s
BF16_AGREE = 0.75  # bf16 codes against fp32 (the JAX package's bound)
NEAR_TIE = 1e-4  # a card token's gap to the CPU's top logit, relative
SNR_DB = 15.0  # decode SNR of the same codes, bf16 against fp32


def noisy_clean(rng, n, sr=SR):
    """A synthetic speech-like clip and a noisy copy, the same peak scale
    (0.8 at the noisy one's peak)."""
    clean = 0.5 * synth_speech(rng, n, sr)
    noisy = clean + 0.1 * rng.standard_normal(n)
    scale = 0.8 / np.abs(noisy).max()
    return ((noisy * scale).astype(np.float32),
            (clean * scale).astype(np.float32))


def teacher_forced_gaps(torch, unise, wav, g, s, task="se", enroll=None):
    """The card's greedy tokens ``g`` (B, 32) and ``s`` (B, 250) of
    ``task`` on ``wav`` (1, T), with the enrollment ``enroll`` (1, T_e)
    for "tse" and "rtse", teacher-forced through a CPU copy of ``unise``'s
    WavLM and LM (fp32) -> (each card token's gap to the CPU's top logit
    of its range, relative to |top| floored at 1, (B, 282); whether the
    CPU's argmax is the card's token, (B, 282))."""
    import copy

    from unified_audio_tpu_torch.models.lm.llama import range_mask
    from unified_audio_tpu_torch.models.unise.model import TASK_MAP

    sft = copy.deepcopy(unise.sft).cpu().float()
    cpu = type(unise)(unise.config, unise.tokenizer,
                      copy.deepcopy(unise.wavlm).cpu(), sft)
    cfg = sft.cfg
    segs, _ = cpu._segment(wav)
    enroll_feats = None
    if enroll is None:  # SE peak-normalizes its segments, TSE does not
        segs = segs / np.max(np.abs(wav), axis=-1, keepdims=True)
    else:
        enroll_feats = cpu.extract_semantic_features(enroll).expand(
            segs.shape[0], -1, -1)
    g = torch.as_tensor(g).long() + cfg.global_offset
    s = torch.as_tensor(s).long() + cfg.semantic_offset
    b, n_g = g.shape

    def col(i):
        return torch.full((b, 1), i, dtype=torch.long)

    # fed: [gSOS g1..g32 sSOS s1..s249]; position 32 predicts the discarded
    # 33rd global sample
    fed = torch.cat([col(cfg.global_sos), g, col(cfg.semantic_sos),
                     s[:, :-1]], 1)
    with torch.no_grad():
        embeds = torch.cat([sft.prompt(TASK_MAP[task], enroll_feats,
                                       cpu.extract_semantic_features(segs)),
                            sft.codec_embedding(fed)], 1)
        logits = sft.output_head(sft.backbone(embeds)[:, -fed.shape[1]:])
    ranged = torch.cat([
        logits[:, :n_g] + range_mask(cfg, cfg.global_offset, cfg.global_size),
        logits[:, n_g + 1:] + range_mask(cfg, cfg.semantic_offset,
                                         cfg.semantic_size)], 1).float()
    tokens = torch.cat([g, s], 1)
    top = ranged.max(-1).values
    mine = ranged.gather(-1, tokens[..., None])[..., 0]
    gap = (top - mine) / top.abs().clamp(min=1.0)
    return gap.numpy(), (ranged.argmax(-1) == tokens).numpy()


def enhance_phase(torch, cli, gpu, tmp, write_wav, read_wav):
    """Phase 9a: ``cli enhance --mode se``, then ``--mode ss``, on a 7.5-s
    noisy clip; every generate call's tokens (SE; ss's SE, TSE and rTSE)
    held to a CPU run of the same model."""
    from unified_audio_tpu_torch.models.unise.model import UniSE

    noisy, _ = noisy_clean(np.random.default_rng(9), int(ENHANCE_S * SR))
    write_wav(tmp / "noisy.wav", noisy, SR)
    built, calls = [], []
    build, decode = cli._build_unise, UniSE._decode_tokens

    def once(**kw):  # the stack is built by the first command only
        if not built:
            t0 = time.perf_counter()
            built.append(build(**kw))
            built.append(time.perf_counter() - t0)
        return built[0]

    def recording(self, g, s, orig_len):
        est = decode(self, g, s, orig_len)
        calls.append((torch.as_tensor(g).cpu().numpy(),
                      torch.as_tensor(s).cpu().numpy(), est))
        return est

    tokens = {}
    with patched([(cli, "_build_unise", once),
                  (UniSE, "_decode_tokens", recording)]):
        for mode in ("se", "ss"):
            calls.clear()
            out = tmp / f"enhanced_{mode}.wav"
            t0 = time.perf_counter()
            cli.main(["enhance", "--mode", mode, "--input",
                      str(tmp / "noisy.wav"), "--output", str(out)])
            wall = time.perf_counter() - t0
            unise, build_s = built
            cfg = unise.sft.cfg
            n_seg = unise._segment(noisy[None])[0].shape[0]
            outs = ([out] if mode == "se" else
                    [out.with_name(out.stem + f"_s{i}.wav") for i in (1, 2)])
            for path in outs:
                rec, fs = read_wav(path)
                if not (fs == SR and rec.shape == (1, noisy.size)
                        and np.isfinite(rec).all()):
                    fail(f"enhance {mode}: {path.name} of shape {rec.shape}"
                         f" at {fs} Hz")
            for g, s, _ in calls:
                # ss's first call: SE of the first segment alone
                if not (g.shape[0] == s.shape[0] in (1, n_seg)
                        and g.shape[1] == unise.config.global_tokens
                        and s.shape[1] == unise._semantic_len()
                        and 0 <= g.min() and g.max() < cfg.global_size
                        and 0 <= s.min() and s.max() < cfg.semantic_size):
                    fail(f"enhance {mode}: tokens {g.shape} {s.shape} out "
                         "of range")
            n_tok = sum(g.size + s.size for g, s, _ in calls)
            secs = wall - (build_s if mode == "se" else 0.0)
            print(f"cli enhance --mode {mode} ({ENHANCE_S} s, {n_seg} "
                  "segments): "
                  f"{len(calls)} generate call(s), {n_tok} tokens in "
                  f"{secs:.2f} s = {n_tok / secs:.0f} tokens/s (wall "
                  f"{wall:.2f} s{f' with the {build_s:.1f} s build' if mode == 'se' else ''}"
                  f"); outputs {[p.name for p in outs]} finite | {gpu}",
                  flush=True)
            tokens[mode] = list(calls)
    # ss: SE of the first segment, whose output (cut to one segment and
    # scaled to a 0.99 peak, as separate_ss does) is TSE's and rTSE's
    # enrollment over every segment
    ss_se, ss_tse, ss_rtse = tokens["ss"]
    seg = unise.config.segment_len
    est = ss_se[2][:seg]
    enroll = est[None] / (np.max(np.abs(est)) + 1e-5) * 0.99
    for name, wav, (g, s, _), task, enr in (
            ("se", noisy[None], tokens["se"][0], "se", None),
            ("ss se", noisy[None, :seg], ss_se, "se", None),
            ("ss tse", noisy[None], ss_tse, "tse", enroll),
            ("ss rtse", noisy[None], ss_rtse, "rtse", enroll)):
        gap, same = teacher_forced_gaps(torch, unise, wav, g, s, task, enr)
        parted = np.argwhere(~same)
        print(f"enhance {name} tokens teacher-forced through the CPU's LM: "
              f"{same.mean():.5f} equal to the CPU's argmax, largest gap to "
              f"the top logit {gap.max():.3e} (relative; limit {NEAR_TIE}); "
              "first step where they part: "
              f"{tuple(int(i) for i in parted[0]) if parted.size else 'none'}"
              " (segment, step)", flush=True)
        if not gap.max() <= NEAR_TIE:
            fail(f"enhance {name}: a card token is {gap.max():.3e} below the "
                 "CPU's top logit")
    return unise


def bf16_residual_codes(torch, vq, lat, books):
    """The JAX package's bf16 encode: each layer's search on the fp32
    values, the residual rounded to bf16 after each layer -> (M, nq)."""
    residual, codes = lat, []
    for cb in books:
        idx = vq.nearest_code_ref(residual.float(), cb.float())
        residual = residual - cb[idx.long()]
        codes.append(idx)
    return torch.stack(codes, -1)


def codec_bf16_phase(torch, cli, vq, gpu, tmp, write_wav, read_wav):
    """Phase 9b: ``cli codec --dtype bfloat16`` for HCodec-1.0 and 2.0 on
    10-s clips -> K6 launches of the two round trips."""

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in the kernel round trip")

    k6_launches = 0
    for model, sr in (("hcodec10", SR), ("hcodec20", SR20)):
        n = int(CLIP_S * sr)
        wav, _ = noisy_clean(np.random.default_rng(10), n, sr)
        clip, out = tmp / f"{model}.wav", tmp / f"{model}_bf16.wav"
        write_wav(clip, wav, sr)
        built = []
        build = cli._build_hcodec

        def recording(*args, **kw):
            built.append(build(*args, **kw))
            return built[-1]

        with patched([(cli, "_build_hcodec", recording),
                      (vq, "nearest_code_ref", forbidden),
                      (vq, "rvq_encode_fused_ref", forbidden)]):
            vq.rvq_encode_fused.launches = 0
            summary = cli.main(["codec", "--model", model, "--dtype",
                                "bfloat16", "--input", str(clip),
                                "--output", str(out)])
            k6 = vq.rvq_encode_fused.launches
        if k6 != 2:
            fail(f"{model} bf16: K6 launched {k6} times in a round trip")
        k6_launches += k6
        t16 = built[0]
        lstm_dtypes = {p.dtype for m in t16.codec.modules()
                       if isinstance(m, torch.nn.LSTM)
                       for p in m.parameters()}
        if t16.dtype != torch.bfloat16 or lstm_dtypes != {torch.bfloat16}:
            fail(f"{model} bf16: codec {t16.dtype}, LSTMs {lstm_dtypes}")
        rec, fs = read_wav(out)
        if not (fs == sr and rec.shape == (1, n) and np.isfinite(rec).all()):
            fail(f"{model} bf16 output of shape {rec.shape} at {fs} Hz")
        t32 = cli._build_hcodec(model, device="cuda")  # same seed, fp32
        x = torch.as_tensor(read_wav(clip)[0], device="cuda")
        c32, c16 = t32.tokenize(x), t16.tokenize(x)
        nq = c16[0].shape[1]
        agree = float(np.mean([float((a == b).float().mean())
                               for a, b in zip(c32, c16)]))
        # K6 on the bf16 path's own fp32 latents against the plain search,
        # and against the JAX package's bf16-rounded residual
        worst, dev, first = 0.0, [], None
        for lat, rvq, codes in zip(t16.latents(x), (
                t16.codec.quantizer, t16.codec.semantic_quantizer), c16):
            lat = lat.reshape(-1, lat.shape[-1])
            flat = codes.transpose(-1, -2).reshape(-1, nq)
            share, w, ok = vq.judge_codes(lat.float().contiguous(),
                                          rvq.fp32_codebooks(), flat)
            worst = max(worst, w)
            if not ok:
                fail(f"{model} bf16: K6 codes off the plain search ({w})")
            per_layer = (bf16_residual_codes(torch, vq, lat, rvq.codebooks())
                         == flat).float().mean(0).cpu().numpy()
            dev.append(per_layer)
            parted = np.flatnonzero(per_layer < 1.0)
            if parted.size and (first is None or parted[0] < first):
                first = int(parted[0])
        dev = np.concatenate(dev)
        r32 = t32.detokenize(*c32)
        r16 = t16.detokenize(*c32)
        if r16.dtype != torch.float32:
            fail(f"{model} bf16 decode gave {r16.dtype}")
        snr = float(10 * torch.log10(r32.square().mean()
                                     / (r16 - r32).square().mean()))
        print(f"{model} bf16 through cli codec: codes "
              f"{summary['acoustic_shape']}, K6 launches {k6}; codes equal "
              f"to fp32 {agree:.5f} (limit {BF16_AGREE}); K6 on the bf16 "
              f"latents vs the plain search: worst distance excess "
              f"{worst:.3e}; vs a bf16-rounded residual (the JAX package's "
              f"encode) {dev.mean():.5f} equal over {nq} layers x 2 streams,"
              f" layer 0 {min(dev[0], dev[nq]):.5f}, first layer below 1: "
              f"{first}; decode SNR of the fp32 codes, bf16 vs fp32 "
              f"{snr:.2f} dB (limit {SNR_DB}) | {gpu}", flush=True)
        if agree < BF16_AGREE or not snr > SNR_DB:
            fail(f"{model} bf16: agreement {agree}, SNR {snr}")

        def roundtrip(tok):
            return lambda: tok.detokenize(*tok.tokenize(x))

        walls = {"fp32": [], "bf16": []}
        for tok in (t32, t16):
            roundtrip(tok)()
        for _ in range(10):  # in turns
            for name, tok in (("fp32", t32), ("bf16", t16)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                roundtrip(tok)()
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in walls.items()}
        print(f"{model} round trip of {CLIP_S:.0f} s, fp32 and bf16 in "
              f"turns, median of 10: fp32 {med['fp32'] * 1e3:.2f} ms (rtfx "
              f"{CLIP_S / med['fp32']:.2f}), bf16 {med['bf16'] * 1e3:.2f} ms "
              f"(rtfx {CLIP_S / med['bf16']:.2f}) | {gpu}", flush=True)
        del t32, t16
        built.clear()
        torch.cuda.empty_cache()
    return k6_launches


def eval_phase(torch, cli, vq, gpu, tmp, write_wav):
    """Phase 9c: ``cli eval --mode se --spk-sim --utmos-ckpt`` over 4
    noisy/clean pairs, then ``roundtrip_codec_eval`` through the bf16
    HCodec-1.0 -> K6 launches of the round trips."""
    from unified_audio_tpu_torch.eval.runner import roundtrip_codec_eval
    from unified_audio_tpu_torch.eval.utmos import UTMOSConfig, UTMOSHead
    from unified_audio_tpu_torch.utils.initialization import init_random_

    rng = np.random.default_rng(11)
    for d in ("noisy", "clean"):
        (tmp / d).mkdir()
    for i in range(EVAL_PAIRS):
        noisy, clean = noisy_clean(rng, 5 * SR)
        write_wav(tmp / "noisy" / f"u{i}.wav", noisy, SR)
        write_wav(tmp / "clean" / f"u{i}.wav", clean, SR)
    head = init_random_(UTMOSHead(UTMOSConfig()),
                        torch.Generator().manual_seed(12))
    torch.save(head.state_dict(), tmp / "utmos.pt")
    t0 = time.perf_counter()
    summary = cli.main(["eval", "--mode", "se", "--test-dir",
                        str(tmp / "noisy"), "--tgt-dir", str(tmp / "clean"),
                        "--spk-sim", "--utmos-ckpt", str(tmp / "utmos.pt")])
    wall = time.perf_counter() - t0
    want = {"num_utts", "stoi", "pesq", "pesq_mos_lqo", "utmos_learned",
            "si_snr", "lsd", "spk_sim"}
    if set(summary) != want or summary["num_utts"] != EVAL_PAIRS or not all(
            np.isfinite(v) for v in summary.values()):
        fail(f"cli eval summary {summary}")
    print(f"cli eval --mode se --spk-sim --utmos-ckpt over {EVAL_PAIRS} "
          f"pairs of 5 s: {json.dumps(summary)}; {wall:.2f} s with the "
          f"build, {wall / EVAL_PAIRS:.2f} s an utterance | {gpu}",
          flush=True)

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain VQ search ran in roundtrip_codec_eval")

    tok = cli._build_hcodec("hcodec10", device="cuda", dtype=torch.bfloat16)
    with patched([(vq, "rvq_encode_fused_ref", forbidden)]):
        vq.rvq_encode_fused.launches = 0
        rt = roundtrip_codec_eval(tok, sorted((tmp / "clean").glob("*.wav")))
        k6 = vq.rvq_encode_fused.launches
    if k6 != 2 * EVAL_PAIRS or not all(np.isfinite(v) for v in rt.values()):
        fail(f"roundtrip_codec_eval: K6 launches {k6}, summary {rt}")
    print(f"roundtrip_codec_eval, bf16 HCodec-1.0, {EVAL_PAIRS} clips: "
          f"{json.dumps(rt)}; K6 launches {k6}", flush=True)
    return k6


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
    from unified_audio_tpu_torch.ops import dsp
    from unified_audio_tpu_torch.ops.cuda.build import load_library
    from unified_audio_tpu_torch.serve import paged
    from unified_audio_tpu_torch.serve.engine import ContinuousBatchingEngine

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
    for name, kernel, ref, quant, check in (
            ("K1", pa.paged_flash_decode_owner,
             pa.paged_flash_decode_owner_ref, False, check_kernel),
            ("K2", pa.paged_flash_decode_owner_q8,
             pa.paged_flash_decode_owner_q8_ref, True, check_kernel),
            ("K3", pa.paged_flash_decode_stream_flat,
             pa.paged_flash_decode_stream_flat_ref, False, check_stream),
            ("K4", pa.paged_flash_decode_stream_flat_q8,
             pa.paged_flash_decode_stream_flat_q8_ref, True, check_stream),
            ("K7", pa.paged_flash_decode, pa.paged_flash_decode_ref, False,
             check_table)):
        for dtype in (torch.float32, torch.bfloat16):
            r = check(torch, pa, kernel, ref, dtype, quant)
            results[name, dtype] = r
            report(name, kernel, dtype, r, gpu)
    vq_results = {}
    for m in (240, 250, 2000):
        line, plan = vq_plan_line(torch, vq, m)
        print(line, flush=True)
        for name, (share, worst, ms, plain_ms, n_rec) in check_vq(
                torch, vq, m).items():
            vq_results[name, m] = (worst, ms, plain_ms, n_rec)
            nq = 1 if name == "K5" else VQ_SHAPES["nq"]
            b_ms, _ = vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"], nq)
            print(f"{name} at M={m}, N=1024, D=512"
                  f"{'' if name == 'K5' else ', nq=4'}: {share:.5f} of codes "
                  f"equal to plain, worst distance excess {worst:.3e}; kernel"
                  f" {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
                  f"{b_ms * 1e3:.2f} us (3xTF32 at 495 TFLOP/s); L2 bytes "
                  f"{plan['l2_bytes'][nq]} | {gpu}", flush=True)

    # 3. UniSE serving. From here on K7's count holds the serving paths'
    # launches; the smoke's own K7 checks go to ``tally``.
    tally = {pa.paged_flash_decode.__name__: pa.paged_flash_decode.launches}
    pa.paged_flash_decode.launches = 0
    records = []
    decode = UniSE._decode_tokens

    def recording(self, g, s, orig_len):
        wav = decode(self, g, s, orig_len)
        records.append((np.asarray(g), np.asarray(s), wav, orig_len))
        recording.unise = self
        return wav

    def forbidden(*args, **kwargs):
        raise AssertionError("a plain attention path ran during serving")

    admitted = {}  # uid -> the request as the engine admitted it
    admit = ContinuousBatchingEngine.admit_many

    def recording_admit(self, reqs):
        admitted.update((r.uid, r) for r in reqs)
        return admit(self, reqs)

    guards = [(UniSE, "_decode_tokens", recording),
              (ContinuousBatchingEngine, "admit_many", recording_admit),
              (paged, "_plain_attention", forbidden),
              (pa, "paged_flash_decode_owner_ref", forbidden),
              (pa, "paged_flash_decode_owner_q8_ref", forbidden)]
    rng = np.random.default_rng(0)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp, patched(guards):
        tmp = Path(tmp)
        spec1 = ([("se", 7.5, i % 2 == 1) for i in range(8)]
                 + [("tse", 7.5, False), ("tse", 7.5, True),
                    ("rtse", 7.5, False), ("rtse", 7.5, True),
                    ("ss", 10.0, False), ("ss", 7.5, True),
                    ("se", 5.0, False, 44100)])
        spec2 = [("se", 5.0, False), ("se", 5.0, True), ("tse", 5.0, False),
                 ("rtse", 5.0, True)]
        for name, spec, quant, kernel in (
                ("int8", spec1, "int8", pa.paged_flash_decode_owner_q8),
                ("bf16", spec2, "", pa.paged_flash_decode_owner)):
            path, lines = write_requests(tmp, rng, write_wav, spec, name)
            pa.paged_flash_decode_owner.launches = 0
            pa.paged_flash_decode_owner_q8.launches = 0
            admitted.clear()
            summary, outputs = serve_and_check(torch, cli, path, lines, quant,
                                               records, read_wav)
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
            check_cascades(torch, cli, lines, outputs, records, admitted,
                           read_wav, gpu)
    unise = recording.unise
    for quant in (None, "int8"):
        worst, engines = decode_agreement(torch, unise, quant)
        print(f"teacher-forced fp32 decode, {quant or 'fp32'} pool: owner "
              f"kernels vs plain attention max |logit diff| {worst:.2e}",
              flush=True)
        # sound kernels read 9.5e-7 (fp32 pool) and 7.5e-6 (int8 pool) on
        # an H100; a dropped or doubled key moves logits by far more
        if not worst <= 1e-4:
            fail(f"owner-kernel decode disagrees with the plain path: {worst}")
        if quant is None:  # K7 has no int8 variant (nor has the TPU kernel)
            with uncounted(tally, pa.paged_flash_decode,
                           pa.paged_flash_decode_owner,
                           pa.paged_flash_decode_stream_flat):
                errs = [table_on_live_pool(torch, pa, paged, engines[mode],
                                           against)
                        for mode, against in (("owner", "K1"), ("", "K3"))]
            print(f"K7 on the live fp32 pools of those steps, every layer: "
                  f"vs K1 (owner engine's regions) max abs err "
                  f"{errs[0]:.3e}, vs K3 (plain engine's allocator tables) "
                  f"{errs[1]:.3e}", flush=True)

    # 4. HCodec-1.0 round trip
    with tempfile.TemporaryDirectory() as tmp:
        k5_launches, k6_launches, _, tok = roundtrip_phase(
            torch, cli, vq, gpu, Path(tmp), write_wav, read_wav)

    # 5. HCodec-2.0 round trip
    with tempfile.TemporaryDirectory() as tmp:
        k6_20_launches, k6_20 = hcodec20_phase(torch, cli, vq, dsp, gpu,
                                               Path(tmp), write_wav, read_wav)
    torch.cuda.empty_cache()

    # 6. UniTok-audio in the stream mode
    k3_launches, k4_launches = unitok_phase(torch, cli, pa, paged, tok, unise,
                                            gpu, tally)

    # 7. UniSE SFT training
    with tempfile.TemporaryDirectory() as tmp:
        train_phase(torch, cli, pa, gpu, Path(tmp), write_wav, read_wav)

    # 8. HCodec-1.0 GAN training
    with tempfile.TemporaryDirectory() as tmp:
        k5_train_launches, k6_train_launches, k5_train = codec_train_phase(
            torch, cli, vq, gpu, Path(tmp), write_wav, read_wav)

    # 9. the JAX CLI's remaining commands: enhance, codec --dtype bfloat16,
    # eval
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        enhance_phase(torch, cli, gpu, Path(tmp), write_wav, read_wav)
        k6_cli_launches = codec_bf16_phase(torch, cli, vq, gpu, Path(tmp),
                                           write_wav, read_wav)
        k6_cli_launches += eval_phase(torch, cli, vq, gpu, Path(tmp),
                                      write_wav)
        print(f"phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)

    # 10. nothing of JAX or the JAX package was loaded
    jax_side = {m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "unified_audio_tpu")}
    if jax_side:
        fail(f"the port loaded JAX-side modules: {sorted(jax_side)}")

    # the kernels at the main path's shapes: K1-K4 and K7 bf16 at the
    # serving shapes, K5/K6 at one 10-s clip of HCodec-1.0 (M = 250; K6's
    # ``nq16`` entry at HCodec-2.0's 16 layers, M = 125 and 1184). The
    # functions of
    # K1, K3 and K7 are each one scaled_dot_product_attention call under a
    # boolean mask; no single PyTorch call computes the others: K2/K4
    # dequantize int8 rows by per-token scales, K5/K6 are a product and an
    # argmin
    kernels = []
    k7 = pa.paged_flash_decode
    print(f"K7 launches on the serving paths {k7.launches}; the smoke's own "
          f"K7 check calls {tally[k7.__name__]}", flush=True)
    launches.update({pa.paged_flash_decode_stream_flat.__name__: k3_launches,
                     pa.paged_flash_decode_stream_flat_q8.__name__:
                     k4_launches, k7.__name__: k7.launches})
    for name, fn, tpu in (("K1", pa.paged_flash_decode_owner, K1_TPU),
                          ("K2", pa.paged_flash_decode_owner_q8, K2_TPU),
                          ("K3", pa.paged_flash_decode_stream_flat, K3_TPU),
                          ("K4", pa.paged_flash_decode_stream_flat_q8,
                           K4_TPU),
                          ("K7", k7, K7_TPU)):
        r = results[name, torch.bfloat16]
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": SOURCE, "replaces": tpu,
                        "launches": launches[fn.__name__],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1],
                        "library_ms": r.get("library_ms"),
                        "cold_ms": r["cold_ms"],
                        "cold_plain_ms": r["cold_plain_ms"],
                        "cold_library_ms": r["cold_library_ms"],
                        "records": r["records"]})
    for name, fn, tpu, n_launch, nq in (
            ("K5", vq.nearest_code, K5_TPU, k5_launches + k5_train_launches,
             1),
            ("K6", vq.rvq_encode_fused, K6_TPU,
             k6_launches + k6_20_launches + k6_train_launches
             + k6_cli_launches, 4)):
        err, ms, plain_ms, n_rec = vq_results[name, 250]
        b_ms, b_by = vq_bound(250, VQ_SHAPES["n"], VQ_SHAPES["d"], nq)
        kernels.append({"name": fn.__name__, "route": "cuda",
                        "source": VQ_SOURCE, "replaces": tpu,
                        "launches": n_launch, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                        "records": n_rec})
    kernels[-2]["kmeans_m600"] = k5_train
    kernels[-1]["nq16"] = {
        f"M={m}": {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": vq_bound(m, VQ_SHAPES["n"], VQ_SHAPES["d"],
                                        NQ20)[0], "records": n_rec}
        for m, (_, worst, ms, plain_ms, n_rec) in k6_20.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
