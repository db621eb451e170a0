#!/usr/bin/env python3
"""Count the profiler windows that lose a device record, with and without
``chip_smoke.profiled``'s lead-in kernels, on one CUDA card.

    python3 profiler_windows.py [--windows 20] [--out RESULT.json]

Run from the repository root. Cases: K1's plain version and K1 itself
(bf16, ``serving_case``), each warmed up. For each case and each round,
one call and then ``chip_smoke.ITERS`` calls are profiled without the
lead-in and then with it; a window loses records when its records, by
name, are not ``ITERS`` times those of the one-call window taken with the
lead-in. Prints the card's name and power limit, then one JSON line:
{case: {"without"/"with": windows that lost records, "windows": N,
"lost": {record name: records lost over all windows}}}.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch

import chip_smoke


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profiler_windows: needs a CUDA card")
    from unified_audio_tpu_torch.ops.cuda import paged_attention as pa

    gpu = chip_smoke.gpu_line()
    print(gpu, flush=True)
    call_args = pa.serving_case(False, torch.bfloat16, "cuda")
    cases = {"K1 plain": lambda: pa.paged_flash_decode_owner_ref(*call_args),
             "K1": lambda: pa.paged_flash_decode_owner(*call_args)}
    n = chip_smoke.ITERS
    result = {"gpu": gpu}
    for case, fn in cases.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        want = {k: n * v for k, v in chip_smoke.profiled(torch, fn, 1)[0].items()}
        bad, lost = Counter(), Counter()
        for _ in range(args.windows):
            for lead_in in (False, True):
                counts, _ = chip_smoke.profiled(torch, fn, n, lead_in)
                if dict(counts) != want:
                    bad["with" if lead_in else "without"] += 1
                    lost.update({k[:80]: v for k, v in
                                 (Counter(want) - counts).items()})
        result[case] = {"without": bad["without"], "with": bad["with"],
                        "windows": args.windows, "lost": dict(lost)}
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
