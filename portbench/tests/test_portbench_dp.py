"""The ``unise-train-sft-dp4`` cell's driver on the CPU at tiny sizes, four
ranks over gloo (``dp_rank.py``, one process a rank, each run under its
own timeout): a sound run is correct, and one rank's gradients left out
of the optimizer's mean make it not correct. (The cell runs on four cards
over NCCL; the collectives and the check are the same code.)"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
WORLD = 4


def run_ranks(tmp_path, fault=""):
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.tests.dp_rank", str(tmp_path),
         str(r), str(WORLD), fault], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} did not end in 420 s")
        logs.append(out)
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    checks = json.loads((tmp_path / "checks.json").read_text())
    return all(c["value"] <= c["limit"] for c in checks), checks


@pytest.mark.parametrize("fault", ["", "left_out"])
def test_dp_run(tmp_path, fault):
    ok, checks = run_ranks(tmp_path, fault)
    assert ok == (fault == ""), checks
