"""Tracing and step timing on ``torch.profiler``.

Port of ``unified_audio_tpu/utils/profiling.py``:

    with trace("traces/"):         # a Chrome trace under traces/
        step()

    timer = StepTimer(device="cuda")
    for batch in data:
        with timer:
            step(batch)
    print(timer.summary())

* :func:`trace` records CPU and (when a card is present) CUDA activity and
  writes one Chrome-trace JSON file under ``logdir``; the path is on the
  yielded profiler's ``trace_path``.
* :func:`annotate` names a region (``torch.profiler.record_function``).
* :class:`StepTimer` times each ``with`` block on the host's clock. Given a
  CUDA device it synchronizes that device when a block ends, so a step's
  time covers the work it queued on the card. The JAX package's timer says
  that it blocks on device work but stops its clock without waiting, so
  under asynchronous dispatch it times the enqueue; this one waits.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir):
    """Profile the block's CPU and CUDA activity -> the profiler, whose
    ``trace_path`` names the Chrome trace written under ``logdir`` when
    the block ends."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_path = str(
        logdir / f"trace_{os.getpid()}_{time.time_ns()}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """A named region that shows in :func:`trace`'s output."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timer with a p50/p90 summary. ``device`` (a CUDA
    device or its name) is synchronized when each step ends; None times
    the host alone. The first ``skip_first`` steps (warm-up) are left out
    of the summary while later ones exist."""

    def __init__(self, skip_first: int = 1, device=None):
        self.times: List[float] = []
        self.skip_first = skip_first
        self.device = None if device is None else torch.device(device)
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()  # work queued before the step is not its own
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        times = sorted(self.times[self.skip_first:] or self.times)
        n = len(times)
        return {
            "steps": n,
            "mean_s": sum(times) / n,
            "p50_s": times[n // 2],
            "p90_s": times[min(n - 1, int(n * 0.9))],
            "min_s": times[0],
        }
