#!/usr/bin/env python3
"""Where the serving passes of ``chip_smoke.py`` spend their time, for
source trees on one card, in turns.

    python3 profile_serve.py NAME=DIR ... [--order NAME ...] --out-dir OUT_DIR

A developer's tool beside ``chip_smoke.py`` and ``smoke_phases.py``;
nothing in the package runs it. Each DIR is a checkout of the repository
(for example a ``git archive`` of another commit). The request files are
phase 3's, written once from this tree's ``chip_smoke.py`` (same seed, same
lines), so every tree serves the same inputs. Each run is one process per
tree, in the order of ``--order`` (default: each tree once), that runs the
tree's own code on:

* ``cli serve`` on phase 3's int8-pool file (15 lines, 35 segments, with
  two "ss" cascades) and on its bf16-pool file (4 lines), the LM bf16 with
  random weights, as phase 3 runs them;
* phase 6's int8 stream-pool UniTok pass: 24 requests over the 7 tasks
  through a 16-slot ``UniTokEngine`` (full-width LM, bf16).

Each pass is timed as the smoke times it (the engine's wall), and split on
the host: the per-step host time of every decode step (the engine's
one-step method wrapped, no synchronization added), admission and
harvest. The 20 decode steps from the 100th of each pass are traced with
``torch.profiler``: launches, device kernel time and the device's busy
share per step. Since the eager step is host-bound, a pass's wall is its
steps' host time plus what lies outside the steps; a change in the wall
with the same launches and device time per step is host time.

Prints one JSON line a pass and a table, and writes them to
``OUT_DIR/serve_passes.json``. Exits 1 when a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WINDOW = (100, 120)  # the traced decode steps of each pass
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
PASSES = ("serve int8", "serve bf16", "unitok int8")


def write_requests(out: Path) -> dict:
    """Phase 3's two request files (its specs and seed) -> {pool: path}."""
    sys.path.insert(0, str(HERE))
    import chip_smoke
    from unified_audio_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(0)
    spec1 = ([("se", 7.5, i % 2 == 1) for i in range(8)]
             + [("tse", 7.5, False), ("tse", 7.5, True),
                ("rtse", 7.5, False), ("rtse", 7.5, True),
                ("ss", 10.0, False), ("ss", 7.5, True),
                ("se", 5.0, False, 44100)])
    spec2 = [("se", 5.0, False), ("se", 5.0, True), ("tse", 5.0, False),
             ("rtse", 5.0, True)]
    out.mkdir(parents=True, exist_ok=True)
    return {name: str(chip_smoke.write_requests(out, rng, write_wav, spec,
                                                name)[0])
            for name, spec in (("int8", spec1), ("bf16", spec2))}


class StepClock:
    """Wraps a class's one-step method: host seconds per call, and a
    ``torch.profiler`` trace of the calls in ``WINDOW``."""

    def __init__(self, torch, cls):
        self.torch, self.cls = torch, cls
        # the one-step method: ``_step_one`` where ``step`` takes n steps
        self.name = "_step_one" if hasattr(cls, "_step_one") else "step"
        self.inner = getattr(cls, self.name)
        self.reset()

    def reset(self):
        self.times, self.prof, self.window_s = [], None, 0.0

    def __enter__(self):
        clock = self

        def wrapped(eng, *a, **k):
            i = len(clock.times)
            if i == WINDOW[0]:
                clock.start_window()
            t0 = time.perf_counter()
            out = clock.inner(eng, *a, **k)
            clock.times.append(time.perf_counter() - t0)
            if i == WINDOW[1] - 1:
                clock.end_window()
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.inner)

    def start_window(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_window = time.perf_counter()

    def end_window(self):
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t_window
        self.prof.__exit__(None, None, None)

    def summary(self):
        n = WINDOW[1] - WINDOW[0]
        out = {"steps": len(self.times),
               "steps_host_s": float(sum(self.times)),
               "step_host_ms_median": 1e3 * float(np.median(self.times)),
               "step_host_ms_mean": 1e3 * float(np.mean(self.times))}
        if self.prof is None:
            return out
        device_us, launches = 0.0, 0
        for ev in self.prof.events():
            if ev.device_type == self.torch.autograd.DeviceType.CUDA:
                device_us += ev.time_range.elapsed_us()
            elif ev.name in LAUNCH_CALLS:
                launches += 1
        out.update({
            "window_launches_per_step": launches / n,
            "window_device_ms_per_step": 1e-3 * device_us / n,
            "window_wall_ms_per_step": 1e3 * self.window_s / n,
            "window_device_busy_share": 1e-3 * device_us / (
                1e3 * self.window_s) if self.window_s else None})
        return out


class HostClock:
    """Host seconds spent in some methods of a class (no sync added)."""

    def __init__(self, cls, names):
        self.cls, self.names, self.saved, self.s = cls, names, {}, {}

    def __enter__(self):
        for name in self.names:
            inner = self.saved[name] = getattr(self.cls, name)
            self.s[name] = 0.0

            def wrapped(eng, *a, _inner=inner, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _inner(eng, *a, **k)
                finally:
                    self.s[_name] += time.perf_counter() - t0

            setattr(self.cls, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, inner in self.saved.items():
            setattr(self.cls, name, inner)


def child(tree: Path, reqs: dict, out: Path):
    """One tree's passes (runs inside the tree's own process)."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch

    import chip_smoke
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.ops.cuda.build import load_library
    from unified_audio_tpu_torch.models.unitok.model import (UniTokConfig,
                                                             UniTokLM)
    from unified_audio_tpu_torch.serve.engine import ContinuousBatchingEngine
    from unified_audio_tpu_torch.serve.unitok_engine import UniTokEngine
    from unified_audio_tpu_torch.utils.initialization import init_random_

    load_library("paged_attention.cu")  # built before anything is timed
    records = []
    for pool in ("int8", "bf16"):
        argv = ["serve", "--requests", reqs[pool]]
        if pool == "int8":
            argv += ["--kv-quant", "int8"]
        with StepClock(torch, ContinuousBatchingEngine) as steps, \
                HostClock(ContinuousBatchingEngine,
                          ("admit_many", "harvest")) as host:
            summary = cli.main(argv)
        st = summary["engine_stats"]
        records.append({
            "pass": f"serve {pool}", "engine_s": summary["engine_s"],
            "rate": st["tokens_generated"] / summary["engine_s"],
            "decode_steps": st["decode_steps"],
            "prefill_waves": st["prefill_waves"],
            "admit_s": host.s["admit_many"],
            "harvest_s": host.s["harvest"], **steps.summary()})

    tok = cli._build_hcodec("hcodec10", device="cuda")
    rng = np.random.default_rng(5)
    t_reqs = chip_smoke.unitok_requests(torch, tok, rng, 24)
    cfg = UniTokConfig()
    with torch.device("cuda"):
        lm = UniTokLM(cfg)
    init_random_(lm, torch.Generator(device="cuda").manual_seed(3)).eval()
    lm.to(torch.bfloat16)
    eng = UniTokEngine(lm, num_slots=16, use_kernel="stream", kv_quant="int8")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with StepClock(torch, UniTokEngine) as steps, \
            HostClock(UniTokEngine, ("admit_wave", "harvest")) as host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(t_reqs, gen)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
    st = eng.stats()
    n_codes = cfg.num_codebooks * sum(r.num_frames for r in t_reqs)
    records.append({
        "pass": "unitok int8", "engine_s": engine_s,
        "rate": n_codes / engine_s, "decode_steps": st["decode_steps"],
        "prefill_waves": st["prefill_waves"],
        "admit_s": host.s["admit_wave"], "harvest_s": host.s["harvest"],
        **steps.summary()})
    for r in records:
        r["outside_steps_s"] = r["engine_s"] - r["steps_host_s"]
    out.write_text(json.dumps(records))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*", help="NAME=DIR")
    ap.add_argument("--order", nargs="+")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--requests", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.child), json.loads(args.requests), Path(args.result))
        return 0
    out_dir = Path(args.out_dir).resolve()
    trees = dict(t.split("=", 1) for t in args.trees)
    reqs = write_requests(out_dir / "requests")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu, flush=True)
    runs, failed = [], False
    for k, name in enumerate(args.order or list(trees)):
        result = out_dir / f"{name}_{k}.json"
        log = out_dir / f"{name}_{k}.log"
        with log.open("w") as f:
            rc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--out-dir",
                 str(out_dir), "--child", str(Path(trees[name]).resolve()),
                 "--requests", json.dumps(reqs), "--result", str(result)],
                stdout=f, stderr=subprocess.STDOUT).returncode
        if rc != 0:
            failed = True
            print(json.dumps({"tree": name, "run": k, "rc": rc,
                              "log": str(log)}), flush=True)
            continue
        for rec in json.loads(result.read_text()):
            rec.update(tree=name, run=k, gpu=gpu)
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    (out_dir / "serve_passes.json").write_text(json.dumps(runs, indent=1))
    cols = ("rate", "engine_s", "steps_host_s", "step_host_ms_median",
            "outside_steps_s", "admit_s", "window_launches_per_step",
            "window_device_ms_per_step", "window_device_busy_share")
    print("pass        tree_run  " + " ".join(f"{c[:14]:>14}" for c in cols))
    for p in PASSES:
        for r in runs:
            if r["pass"] == p:
                print(f"{p:<11} {r['tree'] + '_' + str(r['run']):>9} "
                      + " ".join(f"{r.get(c, float('nan')):>14.4f}"
                                 for c in cols))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
