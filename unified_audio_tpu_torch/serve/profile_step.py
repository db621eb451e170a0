"""Where a serving run's time goes, on one CUDA card.

    python -m unified_audio_tpu_torch.serve.profile_step [--model unise|unitok]
        [--out PROFILE.json]

``--model unise`` (the default) builds the full-width UniSE stack as
``cli serve`` does (random weights, LM bf16, WavLM and BiCodec fp32) and,
for each KV pool format in turn (int8, bf16, int8, bf16: the two
alternate), admits 16 five-second segments (8 SE, 8 TSE with 5-s enrolls,
half of them sampled) into a 16-slot engine in the owner mode (K1/K2).
``--model unitok`` builds UniTok-audio at full width (``UniTokConfig``,
LM bf16) over a full-width HCodec-1.0 (fp32) and admits 16 requests (SR,
SS, CODEC and AE on 5-s inputs, 125 codec frames each, half sampled) into
a 16-slot ``UniTokEngine`` in the stream mode (K3 for the bf16 pool, K4
for the int8 pool). For each it measures:

* admission (frontend + prompt + prefill + scatter) of the wave;
* the decode step at two points of the decode (UniSE's 283 steps: after
  70 and after 240; UniTok's 132: after 20 and after 90), with the cached
  tokens per slot: wall time per step over 20 unprofiled steps, then the
  same number of steps under ``torch.profiler`` for device kernel time
  per step, the device-busy share of the unprofiled step, kernel launches
  per step, the attention kernel's time per call and share of device
  time, and the kernels by device time;
* the engine's own ``run`` over twice as many requests as slots
  (displacing admission, the stashed outputs drained in one read): its
  wall time, the host time by phase (``t_prestage``, ``t_admit``,
  ``t_step``, ``t_drain``, ``t_harvest``; UniSE only) and its counters
  (``stash_fetches``, step calls, decode steps, prefill waves);
* the frontend alone (WavLM; HuBERT features) and the detokenize alone
  (``BiCodec``; HCodec-1.0 ``codes_to_audio``) on the 16 requests (warm,
  synchronized wall time);
* UniSE only, ``--pairs`` N (default 10, 0 skips it): the two schedulers
  on 20 segments over the 16 slots of an int8 pool (the shape of
  ``chip_smoke.py`` phase 13 (a)), the displacing ``run`` against the
  admit/step/harvest loop (``harvest_loop``), after one pass of each
  untimed, in N pairs whose order alternates (run first, then loop first):
  each pass's wall and host split, then the medians and the paired
  differences. Then one pass of each under ``torch.profiler``: device
  kernel time and busy share, launches, the CUDA runtime's copy and
  synchronization calls, and the operators whose host time differs most
  between the two.

Prints one JSON object per measurement and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
POOLS = ("int8", "bf16") * 2  # alternated: host time drifts between runs
ATTENTION_KERNELS = ("owner_decode_kernel", "stream_decode_kernel")
SLOTS = 16  # the serving default
RUN_KEYS = ("t_prestage", "t_admit", "t_step", "t_drain", "t_harvest",
            "stash_fetches", "step_dispatches", "decode_steps",
            "prefill_waves", "requests_completed")
WINDOW = 20  # decode steps per timed and per profiled window
SEED = 0
PAIR_SEGMENTS = 20  # the schedulers' requests: the 16 slots and 4 more
RUNTIME_CALLS = ("Memcpy", "Synchronize", "HostAlloc", "StreamWaitEvent",
                 "EventRecord", "EventQuery")


def _wall(fn):
    """-> (seconds, fn()), the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _steps(eng, gen, n):
    eng.step(n, gen)


def harvest_loop(eng, reqs, gen):
    """Serve ``reqs`` by the admit/step/harvest loop: harvest (a device
    read) before each admission, so no slot is displaced, then decode to
    the next completion -> (results, host seconds in ``t_admit``,
    ``t_step`` and ``t_harvest``)."""
    pending, out = list(reqs), {}
    split = {"t_admit": 0.0, "t_step": 0.0, "t_harvest": 0.0}

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        split[key] += time.perf_counter() - t0
        return res

    while True:
        out.update({r.uid: r for r in timed("t_harvest", eng.harvest)})
        if pending:
            admitted = set(timed("t_admit",
                                 lambda: eng.admit_many(pending)))
            pending = [r for r in pending if r.uid not in admitted]
        live = [eng._remaining[i] for i in range(eng.num_slots)
                if eng._uids[i] is not None and eng._remaining[i] > 0]
        if not live:
            return out, split
        timed("t_step", lambda: eng.step(min(live), gen))


def _displacing_run(eng, reqs, gen):
    """``eng.run(reqs)`` timed -> (results, the run's wall and counter
    deltas: the keys of ``RUN_KEYS`` the engine keeps)."""
    before = eng.stats()
    run_s, out = _wall(lambda: eng.run(reqs, gen))
    after = eng.stats()
    return out, {"s": run_s, **{k: after[k] - before.get(k, 0)
                                for k in RUN_KEYS if k in after}}


def _window(eng, gen, n_steps, active=None):
    """Unprofiled then profiled decode steps -> one measurement dict;
    ``active`` (S,) bool marks the slots still decoding (by default the
    UniSE engine's slots not in the done phase)."""
    from torch.profiler import ProfilerActivity, profile

    if active is None:
        active = eng.state["phase"] != 2
    index = eng.state["index"][active]
    wall_s, _ = _wall(lambda: _steps(eng, gen, n_steps))
    step_ms = 1e3 * wall_s / n_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _steps(eng, gen, n_steps)
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
    # the attention kernels by name: owner_decode_kernel_tiled (K1),
    # owner_decode_kernel_pipelined (K2) and stream_decode_kernel_pipelined
    # (K3, K4)
    attn = [(us, n) for name, (us, n) in by_kernel.items()
            if any(k in name for k in ATTENTION_KERNELS)]
    attn_us = sum(us for us, _ in attn)
    attn_calls = sum(n for _, n in attn)
    if by_kernel and not attn_calls:
        sys.exit("profile_step: no attention kernel among the device "
                 f"kernels (names containing {ATTENTION_KERNELS}); a renamed "
                 "kernel would read as 0 us")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "cached_tokens_min": int(index.min()) + 1,
        "cached_tokens_max": int(index.max()) + 1,
        "step_ms": step_ms,
        # None: the profiler saw no device activity (not measured)
        "device_ms_per_step": (1e-3 * device_us / n_steps) if by_kernel
        else None,
        "device_busy_share": (1e-3 * device_us / n_steps / step_ms)
        if by_kernel else None,
        "launches_per_step": launches / n_steps,
        "attention_kernel_us_per_call": attn_us / attn_calls if attn_calls
        else None,
        "attention_kernel_share_of_device": attn_us / device_us if device_us
        else None,
        "top_kernels": [{"name": name[:90], "us_per_step": us / n_steps,
                         "calls_per_step": n / n_steps,
                         "share": us / device_us}
                        for name, (us, n) in top],
    }


def _requests(n, seg_len, sem_len, seed):
    from ..serve.engine import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        mix = (0.3 * rng.standard_normal(seg_len)).astype(np.float32)
        enroll = ((0.3 * rng.standard_normal(seg_len)).astype(np.float32)
                  if i % 2 else None)
        reqs.append(Request(task_id=i % 2, mix_wav=mix, enroll_wav=enroll,
                            semantic_length=sem_len, do_sample=i % 4 >= 2,
                            uid=i))
    return reqs


def _unitok(emit):
    """The UniTok-audio measurements (``--model unitok``)."""
    from ..models.unitok.model import UNITOK_TASKS
    from ..models.unitok.pipeline import UniTokPipeline
    from .unitok_engine import UniTokEngine, UniTokRequest

    pipe = UniTokPipeline.from_random(seed=SEED, device="cuda")
    tok, lm = pipe.tokenizer, pipe.lm.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    wavs = torch.as_tensor((0.3 * rng.standard_normal((SLOTS, 80000))).astype(
        np.float32), device="cuda")
    t = [_wall(lambda: tok.extract_features(tok.pad_wav(wavs)))[0]
         for _ in range(3)]
    emit({"phase": "hubert", "requests": SLOTS, "s_first": t[0],
          "s_warm": t[-1]})
    feats = tok.extract_features(tok.pad_wav(wavs)).cpu().numpy()
    tasks = [UNITOK_TASKS[t] for t in ("sr", "ss", "codec", "ae")]
    frames = wavs.shape[1] // tok.hop_length
    reqs = [UniTokRequest(task_id=tasks[i % 4], num_frames=frames,
                          input_feats=feats[i], do_sample=i % 4 >= 2, uid=i)
            for i in range(SLOTS)]
    for run, pool in enumerate(POOLS):
        eng = UniTokEngine(lm, num_slots=SLOTS, use_kernel="stream",
                           kv_quant="int8" if pool == "int8" else None)
        admit_s, admitted = _wall(lambda: eng.admit_wave(reqs))
        if len(admitted) != len(reqs):
            sys.exit(f"profile_step: admitted {len(admitted)} of {len(reqs)}")
        emit({"phase": "admission", "model": "unitok", "pool": pool,
              "run": run, "requests": len(admitted), "s": admit_s})
        done = 0
        for at in (20, 90):
            _steps(eng, gen, at - done)
            emit({"phase": "decode_step", "model": "unitok", "pool": pool,
                  "run": run, "after_steps": at,
                  **_window(eng, gen, WINDOW, eng.state["active"])})
            done = at + 2 * WINDOW
        out = {}
        while len(out) < len(reqs):
            eng.step(1, gen)
            out.update({r.uid: r for r in eng.harvest()})
        twice = [dataclasses.replace(r, uid=r.uid + k * len(reqs))
                 for k in (1, 2) for r in reqs]
        _, rec = _displacing_run(eng, twice, gen)
        emit({"phase": "run", "model": "unitok", "pool": pool, "run": run,
              "requests": len(twice), **rec})
    codes = torch.as_tensor(np.stack([out[r.uid].codes for r in reqs]),
                            device="cuda").long()
    t = [_wall(lambda: pipe.codes_to_audio(codes))[0] for _ in range(3)]
    emit({"phase": "detokenize", "model": "unitok", "requests": len(reqs),
          "s_first": t[0], "s_warm": t[-1]})


def main(argv=None):
    p = argparse.ArgumentParser(prog="profile_step")
    p.add_argument("--model", choices=("unise", "unitok"), default="unise")
    p.add_argument("--out", default=None, help="write the results as JSON")
    p.add_argument("--pairs", type=int, default=10,
                   help="UniSE: run/loop pairs of the scheduler comparison "
                        "(0 skips it)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: needs a CUDA card")
    results = []

    def emit(rec):
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if args.model == "unitok":
        _unitok(emit)
    else:
        _unise(emit, args.pairs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


def _unise(emit, pairs):
    """The UniSE measurements (``--model unise``)."""
    from ..cli import _build_unise, make_engine

    unise = _build_unise(device="cuda")
    unise.sft.to(torch.bfloat16)
    cfg = unise.config
    sem_len = unise._semantic_len()
    reqs = _requests(SLOTS, cfg.segment_len, sem_len, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wavs = torch.as_tensor(np.stack([r.mix_wav for r in reqs]),
                           device="cuda")
    with torch.no_grad():
        t = [_wall(lambda: unise.wavlm_feats(wavs))[0] for _ in range(3)]
    emit({"phase": "wavlm", "segments": len(reqs), "s_first": t[0],
          "s_warm": t[-1]})

    for run, pool in enumerate(POOLS):
        eng = make_engine(unise, SLOTS, "int8" if pool == "int8" else None)
        admit_s, admitted = _wall(lambda: eng.admit_many(reqs))
        if len(admitted) != len(reqs):
            sys.exit(f"profile_step: admitted {len(admitted)} of {len(reqs)}")
        emit({"phase": "admission", "pool": pool, "run": run,
              "segments": len(admitted), "s": admit_s})
        done = 0
        for at in (70, 240):
            _steps(eng, gen, at - done)
            emit({"phase": "decode_step", "pool": pool, "run": run,
                  "after_steps": at,
                  **_window(eng, gen, WINDOW)})
            done = at + 2 * WINDOW
        out = {}
        while len(out) < len(reqs):
            eng.step(1, gen)
            out.update({r.uid: r for r in eng.harvest()})
        twice = [dataclasses.replace(r, uid=r.uid + k * len(reqs))
                 for k in (1, 2) for r in reqs]
        _, rec = _displacing_run(eng, twice, gen)
        emit({"phase": "run", "pool": pool, "run": run,
              "segments": len(twice), **rec})
    g = np.stack([out[r.uid].global_ids for r in reqs])
    s = np.stack([out[r.uid].semantic_ids for r in reqs])
    with torch.no_grad():
        t = [_wall(lambda: unise._decode_tokens(
            g, s, len(reqs) * cfg.segment_len))[0] for _ in range(3)]
    emit({"phase": "detokenize", "segments": len(reqs), "s_first": t[0],
          "s_warm": t[-1]})
    if pairs:
        _schedulers(unise, emit, pairs)


def _scheduler_pass(eng, kind, reqs):
    """One pass of ``kind`` ("run" or "loop") over ``reqs``, the generator
    seeded alike -> (results, synchronized wall, host split)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    before = eng.stats()
    if kind == "run":
        wall, out = _wall(lambda: eng.run(reqs, gen))
        after = eng.stats()
        split = {k: after[k] - before.get(k, 0) for k in RUN_KEYS[:5]}
    else:
        wall, (out, split) = _wall(lambda: harvest_loop(eng, reqs, gen))
    split["decode_steps"] = eng.stats()["decode_steps"] - before[
        "decode_steps"]
    return out, wall, split


def _traced_pass(eng, kind, reqs):
    """One pass under ``torch.profiler`` -> (summary, {operator: host
    self ms})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, split = _scheduler_pass(eng, kind, reqs)
    device_us, launches = 0.0, 0
    ops = defaultdict(float)  # name -> host self us
    calls = defaultdict(lambda: [0, 0.0])  # runtime call -> [n, us]
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us += ev.time_range.elapsed_us()
            continue
        ops[ev.name] += ev.self_cpu_time_total
        if ev.name in LAUNCH_CALLS:
            launches += 1
        elif any(c in ev.name for c in RUNTIME_CALLS):
            calls[ev.name][0] += 1
            calls[ev.name][1] += ev.self_cpu_time_total
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    return {"phase": "scheduler_trace", "kind": kind, "s": wall, **split,
            "device_ms": 1e-3 * device_us,
            "device_busy_share": 1e-3 * device_us / (1e3 * wall),
            "launches": launches,
            "runtime_calls": {k: {"n": n, "ms": 1e-3 * us}
                              for k, (n, us) in sorted(calls.items())},
            "top_host_ops_ms": {k: 1e-3 * us for k, us in top}}, ops


def _schedulers(unise, emit, pairs):
    """The displacing ``run`` against the admit/step/harvest loop (see the
    module docstring)."""
    from ..cli import make_engine

    cfg = unise.config
    reqs = _requests(PAIR_SEGMENTS, cfg.segment_len, unise._semantic_len(),
                     SEED + 1)
    greedy = [r.uid for r in reqs if not r.do_sample]
    tokens = sum(r.global_length + 1 + r.semantic_length for r in reqs)
    eng = make_engine(unise, SLOTS, "int8")
    first = None

    def one(kind, pair):
        nonlocal first
        out, wall, split = _scheduler_pass(eng, kind, reqs)
        first = first or out
        if any(not (np.array_equal(out[u].global_ids, first[u].global_ids)
                    and np.array_equal(out[u].semantic_ids,
                                       first[u].semantic_ids))
               for u in greedy):
            sys.exit(f"profile_step: the {kind} pass's greedy tokens differ")
        if pair is not None:
            emit({"phase": "scheduler", "kind": kind, "pair": pair,
                  "s": wall, **split})
        return wall, split

    one("loop", None)  # untimed warm-up passes
    one("run", None)
    walls = {"run": [], "loop": []}
    steps = {"run": [], "loop": []}
    for pair in range(pairs):
        for kind in (("run", "loop") if pair % 2 == 0 else ("loop", "run")):
            wall, split = one(kind, pair)
            walls[kind].append(wall)
            steps[kind].append(split["t_step"])
    diffs = np.subtract(walls["run"], walls["loop"])
    med = {k: float(np.median(v)) for k, v in walls.items()}
    emit({"phase": "schedulers", "pairs": pairs, "segments": len(reqs),
          "tokens": tokens, "run_median_s": med["run"],
          "loop_median_s": med["loop"],
          "run_tokens_per_s": tokens / med["run"],
          "loop_tokens_per_s": tokens / med["loop"],
          "run_t_step_median_s": float(np.median(steps["run"])),
          "loop_t_step_median_s": float(np.median(steps["loop"])),
          "diff_median_s": float(np.median(diffs)),
          "diff_min_s": float(diffs.min()), "diff_max_s": float(diffs.max()),
          "run_slower_pairs": int((diffs > 0).sum())})
    traced = {}
    for kind in ("run", "loop"):
        rec, traced[kind] = _traced_pass(eng, kind, reqs)
        emit(rec)
    names = set(traced["run"]) | set(traced["loop"])
    delta = sorted(((n, traced["run"].get(n, 0.0) - traced["loop"].get(
        n, 0.0)) for n in names), key=lambda kv: -abs(kv[1]))[:12]
    emit({"phase": "scheduler_trace_diff",
          "host_self_ms_run_minus_loop": {n[:90]: 1e-3 * d
                                          for n, d in delta}})


if __name__ == "__main__":
    main()
