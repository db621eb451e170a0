"""The port's utilities (``unified_audio_tpu_torch/utils/token_parser.py``,
``watchdog.py``, ``profiling.py``) against the JAX package's, on the CPU.

The token maps equal JAX's entry for entry and render token strings
alike; the watchdog cases mirror ``tests/test_data.py TestWatchdog``;
``trace`` writes a Chrome trace that names an annotated region and the
ops in it, and ``StepTimer`` summarizes its steps as JAX's does. The
card's half of ``StepTimer`` (it synchronizes the device, so a step's time
covers the kernels it queued) runs in ``chip_smoke.py`` phase 14.
"""
import json
import time

import numpy as np
import pytest
import torch

from unified_audio_tpu.utils import token_parser as j_tp
from unified_audio_tpu_torch.utils import profiling, token_parser, watchdog


@pytest.mark.parametrize("name", ["TASK_TOKEN_MAP", "GENDER_MAP",
                                  "LEVELS_MAP", "EMO_MAP"])
def test_token_maps_equal_jax(name):
    assert getattr(token_parser, name) == getattr(j_tp, name)


def test_token_strings_equal_jax():
    tokens = np.random.default_rng(0).integers(0, 4096, 12)
    for fn in ("global_token_string", "semantic_token_string"):
        assert getattr(token_parser, fn)(tokens) == getattr(j_tp, fn)(tokens)
    assert token_parser.global_token_string([1, 2]) == (
        "<|bicodec_global_1|><|bicodec_global_2|>")


def test_call_with_timeout():
    """Mirrors ``tests/test_data.py TestWatchdog.test_call_with_timeout``:
    a result, a missed deadline, the call's own exception."""
    assert watchdog.call_with_timeout(lambda x: x + 1, 1.0, 41) == 42
    with pytest.raises(watchdog.TimeoutError_):
        watchdog.call_with_timeout(time.sleep, 0.1, 5.0)
    with pytest.raises(ValueError):
        watchdog.call_with_timeout(
            lambda: (_ for _ in ()).throw(ValueError("x")), 1.0)


def test_watchdog_detects_stall():
    """Mirrors ``TestWatchdog.test_watchdog_detects_stall``: no beats for
    longer than the limit fires ``on_stall``."""
    events = []
    with watchdog.Watchdog(on_stall=lambda n, a: events.append(n),
                           poll_interval=0.05) as wd:
        hb = wd.register("producer", limit_seconds=0.1)
        hb.beat()
        time.sleep(0.4)
    assert "producer" in events
    assert wd.stalls["producer"] >= 1


def test_watchdog_quiet_while_beating():
    """A producer that beats inside its limit raises no alarm."""
    events = []
    with watchdog.Watchdog(on_stall=lambda n, a: events.append(n),
                           poll_interval=0.02) as wd:
        hb = wd.register("producer", limit_seconds=1.0)
        for _ in range(20):
            hb.beat()
            time.sleep(0.02)
    assert events == [] and wd.stalls["producer"] == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` on the CPU: one JSON trace under the log directory, with
    the annotated region and the matmul inside it."""
    x = torch.randn(64, 64)
    with profiling.trace(tmp_path / "tb") as prof:
        with profiling.annotate("decode_step"):
            (x @ x).sum()
    files = list((tmp_path / "tb").glob("*.json"))
    assert [str(f) for f in files] == [prof.trace_path]
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "decode_step" in names
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]


def test_step_timer_summary():
    """``StepTimer`` without a device times the host as JAX's does: the
    first step left out, p50/p90 of the rest, each step at least its
    sleep."""
    timer = profiling.StepTimer()
    for s in (0.0, 0.01, 0.02, 0.03):
        with timer:
            time.sleep(s)
    out = timer.summary()
    assert out["steps"] == 3
    assert out["min_s"] >= 0.01 and out["p50_s"] >= 0.02
    assert out["p90_s"] >= out["p50_s"] >= out["min_s"]
    assert out["mean_s"] == pytest.approx(sum(timer.times[1:]) / 3)


def test_step_timer_cpu_device_does_not_sync():
    """A CPU device has no queue to wait for: the timer runs."""
    timer = profiling.StepTimer(device="cpu", skip_first=0)
    with timer:
        pass
    assert timer.summary()["steps"] == 1
