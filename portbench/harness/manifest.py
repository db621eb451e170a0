"""``BENCHMARK.json`` and the files it names, found by name.

A cell's parameters are ``workloads/<cell>.json`` (with ``"driver"``); its
driver is ``drivers/<driver>.py``, its configuration the ``file`` of its
``configs`` entry, its reference ``reference/<config>.py`` and each
per-layer metric ``metrics/<metric>.py``. Adding a cell, a configuration
or a metric is adding files and entries: no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def entry(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_params(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((Path(bench_dir) / "workloads" / f"{name}.json")
                      .read_text())


def config_params(manifest: dict, config: str,
                  root: Path = ROOT) -> dict:
    cfg = entry(manifest["configs"], config, "configuration")
    return json.loads((Path(root) / cfg["file"]).read_text())


def driver_path(driver: str, bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir) / "drivers" / f"{driver}.py"


def metric_path(metric: str, bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir) / "metrics" / f"{metric}.py"


def reference_path(config: str, bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir) / "reference" / f"{config}.py"


def load_module(path: Path, name: str):
    """Import the file at ``path`` as module ``portbench.<name>`` (names may
    hold dots, as the metrics' do), so that a reference's relative imports
    of its folder work."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    key = "portbench." + name
    if key in sys.modules:
        return sys.modules[key]
    importlib.import_module("portbench." + name.split(".")[0])
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def end_to_end_metrics(manifest: dict, cell: str) -> list:
    """The cell's end-to-end metrics: those without ``workloads`` and
    those that list the cell."""
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_metrics(manifest: dict, cell: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without ``workloads`` whose ``moves`` the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(manifest, cell)}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def problems(manifest: dict, root: Path = ROOT) -> list:
    """What in the manifest breaks the naming rules or names a missing
    file (empty when all is well)."""
    out = []
    bench_dir = Path(root) / "portbench"

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME_RE.match(n):
            out.append(f"{what} {n!r} is not a valid name")

    for c in manifest["configs"]:
        name_ok(c["name"], "configuration")
        for k in c["reduced"]:
            name_ok(k, "reduced key")
        if not (Path(root) / c["file"]).is_file():
            out.append(f"configuration file {c['file']} is missing")
        if not reference_path(c["name"], bench_dir).is_file():
            out.append(f"reference of {c['name']} is missing")
    configs = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        name_ok(w["name"], "workload")
        name_ok(w["traffic"], "traffic")
        if w["config"] not in configs:
            out.append(f"workload {w['name']} names no configuration")
        try:
            params = cell_params(w["name"], bench_dir)
        except FileNotFoundError:
            out.append(f"workload file of {w['name']} is missing")
            continue
        if not driver_path(params["driver"], bench_dir).is_file():
            out.append(f"driver {params['driver']} is missing")
        if params.get("config", w["config"]) != w["config"]:
            out.append(f"workload file of {w['name']} names another "
                       "configuration")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        name_ok(m["name"], "metric")
        if not UNIT_RE.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']} is not valid")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better of {m['name']} is {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"source of {m['name']} is {m['source']!r}")
    for m in manifest["per_layer"]:
        if not metric_path(m["name"], bench_dir).is_file():
            out.append(f"reader of {m['name']} is missing")
    return out
