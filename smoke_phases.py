#!/usr/bin/env python3
"""Time the phases of ``chip_smoke.py`` for source trees on one card, in turns.

    python3 smoke_phases.py NAME=DIR ... [--order NAME ...] --out-dir OUT_DIR

A developer's tool beside ``chip_smoke.py``; nothing in the package runs
it. Each DIR is a checkout of the repository (for example a ``git archive``
of another commit). The runs go in the order of ``--order`` (default: each
tree once, in the order given; ``--order parent change change parent``
puts two runs of each around each other). Each run is ``python3
chip_smoke.py`` from its DIR with unbuffered output; every line it writes,
standard output and errors merged, is stamped with the seconds since the
run began and kept in ``OUT_DIR/NAME_RUN.log``.

A phase's time runs from the end of the phase before it to the first line
after that which only the phase's end prints (``PHASE_ENDS``; a smoke
without phase 12 skips its marker). "1-2" starts with the process and holds
Python's and torch's start, the kernels' build and their checks; "end"
holds the phases after the last marker found (phase 13 and the report).
Beside the phases, the lines of the end-to-end numbers that ``KEY_LINES``
names are copied for each run.

Prints one JSON line a run and a table of the phases' seconds, and writes
the lines to ``OUT_DIR/summary.json``. Exits 1 when a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

PHASE_ENDS = (
    ("1-2", r"^K6 at M=2000"),
    ("3", r"^teacher-forced fp32 decode, int8 pool"),
    ("4", r"^round trip with plain VQ"),
    ("5", r"^hcodec20 round trip with plain VQ"),
    ("6", r"^teacher-forced fp32 UniTok decode, int8 pool"),
    ("7", r"^serve --ckpt step"),
    ("8", r"^codec --ckpt step"),
    ("9", r"^phase 9 took"),
    ("10", r"^phase 10 took"),
    ("11", r"^phase 11 took"),
    ("12", r"^phase 12 took"),
)
KEY_LINES = (
    r"^kernels built",
    r"^serve int8 pool",
    r"^serve bf16 pool",
    r"^hcodec10 round trip rtfx",
    r"^hcodec20 round trip rtfx",
    r"^unitok int8 pool",
    r"^shared bf16 pool",
    r"^train step \(median",
    r"^codec train step \(median",
    r"^cli enhance --mode se",
    r"^hcodec15 round trip",
    r"^train-codec causal",
    r"^pretraining:",
    r"^train-unise under torchrun",
)
SMOKE_LIMIT_S = 1200


def stamped_run(tree: Path, log: Path):
    """Run the smoke of ``tree`` -> (exit code, [(seconds, line)])."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    lines = []
    with log.open("w") as f:
        def read():
            for line in proc.stdout:
                t = time.perf_counter() - t0
                lines.append((t, line.rstrip("\n")))
                f.write(f"{t:9.3f} {line}")
                f.flush()

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        try:
            rc = proc.wait(timeout=SMOKE_LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        reader.join()
    lines.append((time.perf_counter() - t0, ""))
    return rc, lines


def phases(lines):
    """{phase: seconds} from the stamped lines (see the module
    docstring)."""
    out, start, i = {}, 0.0, 0
    for name, pattern in PHASE_ENDS:
        for j in range(i, len(lines)):
            if re.search(pattern, lines[j][1]):
                out[name] = lines[j][0] - start
                start, i = lines[j][0], j + 1
                break
    out["end"] = lines[-1][0] - start
    return out


def key_lines(lines):
    found = {}
    for pattern in KEY_LINES:
        for _, line in lines:
            if re.search(pattern, line):
                found[pattern.strip("^").replace("\\", "")] = line
                break
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="NAME=DIR")
    ap.add_argument("--order", nargs="+")
    ap.add_argument("--out-dir", required=True,
                    help="directory for the stamped logs and summary.json")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
    except FileNotFoundError:
        gpu = "no nvidia-smi"
    print(gpu, flush=True)
    runs, failed = [], False
    for k, name in enumerate(args.order or list(trees)):
        rc, lines = stamped_run(Path(trees[name]).resolve(),
                                out_dir / f"{name}_{k}.log")
        run = {"tree": name, "run": k, "rc": rc,
               "total_s": lines[-1][0], "phases": phases(lines),
               "lines": key_lines(lines), "gpu": gpu}
        runs.append(run)
        failed |= rc != 0
        print(json.dumps({key: v for key, v in run.items()
                          if key != "lines"}), flush=True)
    (out_dir / "summary.json").write_text(json.dumps(runs, indent=1))
    names = [name for name, _ in PHASE_ENDS] + ["end"]
    heads = [f"{r['tree']}_{r['run']}" for r in runs]
    print("phase " + " ".join(f"{h:>{len(r['tree']) + 9}}"
                              for h, r in zip(heads, runs)))
    for name in names + ["total"]:
        vals = [r["total_s"] if name == "total" else r["phases"].get(name)
                for r in runs]
        print(f"{name:>5} " + " ".join(
            f"{'-' if v is None else f'{v:.1f}':>{len(r['tree']) + 9}}"
            for v, r in zip(vals, runs)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
