"""Spans and counters, tracing and step timing on ``torch.profiler``.

Port of ``unified_audio_tpu/utils/profiling.py``, with the port's own
recorder of spans and counters:

    with span("engine.step", n=4):   # recorded only while on
        ...
    count("data.loader_cpu_s", dt)

    reset(); enable()
    serve_a_while()
    records = export()               # {"spans": [...], "counts": {...}}
    disable()

    with torch.profiler.profile():   # on while a profiler runs, too
        serve_a_while()

    with trace("traces/"):           # a Chrome trace under traces/
        step()

    timer = StepTimer(device="cuda")
    for batch in data:
        with timer:
            step(batch)
    print(timer.summary())

* :class:`Recorder` keeps one process's spans and counts; the module's
  ``span``, ``count``, ``launched``, ``held``, ``release``,
  ``cpu_time``, ``enable``, ``disable``, ``reset`` and ``export`` are
  those of its one instance, ``RECORDER``.
  The recorder is on while enabled and while a ``torch.profiler`` runs in
  the process. Off (the default), ``span`` and ``cpu_time`` return one
  shared no-op context after two flag checks (its own and the profiler's)
  and ``count`` returns at once: no clock is read and no profiler range is
  entered. On, a span records its name, its ``perf_counter_ns`` start and
  end, its thread, the span open around it on that thread (its parent)
  and its attributes, and enters a profiler range ``"ua:" + name``: in a
  profiled window it then sits on the profiler's clock beside the runtime
  calls and the device records it launched. The range is an operator's
  (``torch._C._profiler._RecordFunctionFast``), not a user annotation
  (``torch.profiler.record_function``), so the profiler makes no copy of
  it on the device's timeline, where it would read as device work.
  Nothing synchronizes: a span measures what the host did, the profiler
  gives the device's side. The spans of the
  serving engine, the SFT step, the data pipeline and the codec are
  named ``engine.*``, ``unise.*``, ``train.*``, ``data.*`` and
  ``codec.*``; those of the LM's layers ``lm.*`` (``lm.mla`` and
  ``lm.moe`` with ``lm.moe.route``, ``.experts``, ``.shared``: the
  Moonlight stack's, in eager steps only, since a replayed CUDA graph
  runs no Python).
* :func:`trace` records CPU and (when a card is present) CUDA activity and
  writes one Chrome-trace JSON file under ``logdir``; the path is on the
  yielded profiler's ``trace_path``. The program's spans show in it.
* :class:`StepTimer` times each ``with`` block on the host's clock. Given a
  CUDA device it synchronizes that device when a block ends, so a step's
  time covers the work it queued on the card. The JAX package's timer says
  that it blocks on device work but stops its clock without waiting, so
  under asynchronous dispatch it times the enqueue; this one waits.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "ua:"  # the profiler ranges of the recorder's spans


def _range(name: str):
    """The profiler range of span ``name``: an operator's range, which the
    profiler keeps on the host's timeline only."""
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


class _Off:
    """What every span and CPU clock is while the recorder is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def note(self, **attrs) -> None:
        """Attributes known only inside the span (what it did)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(self.rec._ids)
        self.thread = threading.get_native_id()
        stack.append(self)
        self._range = _range(self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._range = None
        self.rec._stack().pop()
        self.rec._close(self)
        return False


class _CpuTime:
    """Adds the calling thread's CPU seconds inside the block to a
    counter."""

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.t0 = time.thread_time()
        return self

    def __exit__(self, *exc):
        self.rec.count(self.name, time.thread_time() - self.t0)
        return False


class Recorder:
    """Spans and counts of one process, kept in memory until
    :meth:`export`. Any thread may open spans (each thread has its own
    stack of open spans) and add to counts."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans: List[_Span] = []
        self._counts: Dict[str, float] = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, sp: _Span) -> None:
        with self._lock:
            self._spans.append(sp)

    def span(self, name: str, **attrs):
        """The block as span ``name`` with ``attrs`` (more through the
        context's ``note``) while the recorder is on."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, name, attrs)

    def count(self, name: str, value=1) -> None:
        """Add ``value`` to counter ``name`` while the recorder is on (to
        the dict of the calling thread's open :meth:`held`, if any)."""
        held = getattr(self._local, "held", None)
        if held is not None:
            held[name] = held.get(name, 0) + value
            return
        if not (self.enabled or _profiler._is_profiler_enabled):
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + value

    def cpu_time(self, name: str):
        """The calling thread's CPU seconds inside the block, added to
        counter ``name`` while the recorder is on."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _OFF
        return _CpuTime(self, name)

    def launched(self, wrapper, n=1) -> None:
        """Add ``n`` to a kernel wrapper's ``.launches``, on or off (to
        the dict of the calling thread's open :meth:`held`, keyed by the
        wrapper, if any). Every CUDA kernel wrapper counts through it."""
        held = getattr(self._local, "held", None)
        if held is not None:
            held[wrapper] = held.get(wrapper, 0) + n
        else:
            wrapper.launches += n

    @contextlib.contextmanager
    def held(self):
        """Hold back the counts and launches the calling thread makes
        inside the block, on or off: they go to the yielded dict and
        nowhere else. A CUDA graph's capture runs its step's Python once
        and each replay none, so the serving engine holds the capture's
        counts and :meth:`release` adds them at every replay."""
        held: Dict[object, float] = {}
        self._local.held = held
        try:
            yield held
        finally:
            self._local.held = None

    def release(self, held: dict, times=1) -> None:
        """Make the counts and launches of a :meth:`held` dict ``times``
        over: counters by :meth:`count`, launches by :meth:`launched`."""
        for what, n in held.items():
            if isinstance(what, str):
                self.count(what, n * times)
            else:
                self.launched(what, n * times)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop the spans and counts recorded so far (a span open now is
        recorded when it closes)."""
        with self._lock:
            self._spans = []
            self._counts = {}

    def export(self) -> dict:
        """-> {"spans": [{"id", "parent", "name", "thread", "start_ns",
        "end_ns", "attrs"}, ...] in the order they started, "counts":
        {name: value}}: what was recorded since the last :meth:`reset`.
        ``parent`` is the id of the span around it on its thread (None at
        the top); ``thread`` the thread's native id."""
        with self._lock:
            spans, counts = list(self._spans), dict(self._counts)
        out = [{"id": s.id, "parent": s.parent, "name": s.name,
                "thread": s.thread, "start_ns": s.start, "end_ns": s.end,
                "attrs": dict(s.attrs)} for s in spans]
        out.sort(key=lambda s: (s["start_ns"], s["id"]))
        return {"spans": out, "counts": counts}


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
launched = RECORDER.launched
held = RECORDER.held
release = RECORDER.release
cpu_time = RECORDER.cpu_time
enable = RECORDER.enable
disable = RECORDER.disable
reset = RECORDER.reset
export = RECORDER.export


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
