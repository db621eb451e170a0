"""On the card, at each cell's own size: the program's compared numbers and
its control's (the reference in the program's place one precision down),
seed by seed, one process a cell. The limits in ``workloads/<cell>.json``
were set from these readings: the program's stay under them, the control
fails at least one.

    python -m pytest portbench/tests/test_portbench_controls.py -q -s

``PORTBENCH_SEEDS`` sets the seeds' count (default 3) and
``PORTBENCH_OUT`` a folder for one JSON line a seed and side.
"""
import json
import os
from pathlib import Path

import pytest

from portbench.harness import manifest

BENCH = manifest.load_manifest()
WINDOW_S = {"unise-serve-c96-s64": 12.0, "hcodec10-roundtrip-b16x10s": 4.0,
            "unise-train-sft-b32x5s": 2.0}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch


def _runs(torch, cell, sides):
    """Set-up, a short window and the check of ``cell`` at its own size on
    the seeds (``PORTBENCH_SEEDS``); ``sides`` {name: (fault or None,
    control)} -> [(seed, side, checks)], each line also printed (and
    written under ``PORTBENCH_OUT``)."""
    from argparse import Namespace

    from portbench.harness.context import Run

    entry = manifest.entry(BENCH["workloads"], cell, "workload")
    params = manifest.cell_params(cell)
    drv = manifest.load_module(manifest.driver_path(params["driver"]),
                               "drivers." + params["driver"])
    ref = manifest.load_module(manifest.reference_path(entry["config"]),
                               "reference." + entry["config"])
    out_dir = os.environ.get("PORTBENCH_OUT")
    got = []
    for k in range(int(os.environ.get("PORTBENCH_SEEDS", "3"))):
        seed = 2 ** 31 + 7919 * (k + 1)
        for side, (fault, control) in sides.items():
            with pytest.MonkeyPatch.context() as mp:
                if fault is not None:
                    fault(mp)
                run = Run(torch, Namespace(seed=seed,
                                           seconds=WINDOW_S[cell], trace=0),
                          params, manifest.config_params(
                              BENCH, entry["config"]), entry, ref)
                st = drv.setup(run)
                out = drv.window(run, st)
                drv.release(run, st)
            checks = drv.check(run, st, out)
            got.append((seed, side, checks))
            if control:
                got.append((seed, "control",
                            drv.check(run, st, out, control=True)))
            del st, out
            torch.cuda.empty_cache()
    for seed, side, checks in got:
        line = {"cell": cell, "seed": seed, "side": side,
                **{c["name"]: c["value"] for c in checks}}
        print(json.dumps(line), flush=True)
        if out_dir:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            with open(Path(out_dir) / f"{cell}.jsonl", "a") as f:
                f.write(json.dumps(line) + "\n")
    return got


def _correct(checks):
    return all(c["value"] <= c["limit"] for c in checks)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", sorted(WINDOW_S))
def test_control_fails_where_program_passes(card, cell):
    got = _runs(card, cell, {"program": (None, True)})
    wrong = [g for g in got if _correct(g[2]) != (g[1] == "program")]
    assert not wrong, wrong


TRAIN_FAULTS = ("train_half_batch_left_out", "train_token_altered",
                "train_params_not_written", "train_update_reversed")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_training_fault_fails_on_the_card(card, fault):
    """The training cell's faults at its own size (a state left unchanged
    reads 1 by the gradient's measure, with no run)."""
    from portbench.tests import test_portbench_faults as faults

    got = _runs(card, "unise-train-sft-b32x5s",
                {fault: (getattr(faults, fault), False)})
    passed = [g for g in got if _correct(g[2])]
    assert not passed, passed
