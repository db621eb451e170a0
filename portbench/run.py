"""Run one cell of ``BENCHMARK.json`` once on the CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace 0|1

The cell's parameters (``workloads/<cell>.json``) name its driver
(``drivers/<driver>.py``), which builds the port's system under test with
the benchmark's own weights, warms up the cell's shapes (set-up), drives
the measured window and, once the window has closed and the program's
state is freed, holds what the window produced to the configuration's
plain reference (``reference/<config>.py``). With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (``metrics/<metric>.py``, each reading the spans, counts and the
profiled part of the window). The compared numbers and their limits are
the last lines on standard error and the last key of the result, the one
JSON line printed last on standard output.

Exits non-zero without a result when no CUDA card (or fewer than the cell
asks for) is present, and when a module of JAX or of the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches at fixed places inside the checkout (the port builds its
# own CUDA kernels into build/kernels/); JAX kept out of any library
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import isolation, manifest  # noqa: E402
from portbench.harness.context import Run  # noqa: E402

UNREADABLE = 1e300


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card; the benchmark runs on the card "
                 "only")
    if torch.cuda.device_count() < chips:
        sys.exit(f"portbench: the cell needs {chips} cards, "
                 f"{torch.cuda.device_count()} present")


def device_info(torch, chips: int, peak: int, prof=None) -> dict:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(peak)}
    if prof is not None:
        out["busy_s"] = prof.busy_s()
        out["window_s"] = prof.window_s
    return out


def isolated() -> bool:
    found = isolation.banned_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
    return not found


def main(argv=None) -> int:
    args = parse(argv)
    bench = manifest.load_manifest(ROOT)
    entry = manifest.entry(bench["workloads"], args.workload, "workload")
    cell = manifest.cell_params(args.workload)
    config = manifest.config_params(bench, entry["config"], ROOT)
    import torch

    require_cards(torch, entry["chips"])
    driver = manifest.load_module(manifest.driver_path(cell["driver"]),
                                  "drivers." + cell["driver"])
    reference = manifest.load_module(
        manifest.reference_path(entry["config"]),
        "reference." + entry["config"])
    run = Run(torch, args, cell, config, entry, reference)

    state = driver.setup(run)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    out = driver.window(run, state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not isolated():
        return 4
    driver.release(run, state)
    checks = driver.check(run, state, out)
    for c in checks:  # a number that cannot be read fails, in valid JSON
        if not math.isfinite(c["value"]):
            c["value"] = UNREADABLE

    if args.trace:
        metrics = {}
        for m in manifest.per_layer_metrics(bench, args.workload):
            reader = manifest.load_module(manifest.metric_path(m["name"]),
                                          "metrics." + m["name"])
            value = reader.read(run.records)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in manifest.end_to_end_metrics(bench, args.workload):
            if m["name"] != "setup_s":
                value = float(out["metrics"][m["name"]])
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    prof = run.records["profiled"] if args.trace else None
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info(torch, entry["chips"], peak, prof)}
    if prof is not None:
        result["breakdown"] = prof.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    if not isolated():
        return 4
    sys.stdout.flush()
    for c in checks:
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) "
              f"{ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
