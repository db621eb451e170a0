"""Failure detection: deadlines on blocking calls, heartbeats, stalls.

The port's own copy of ``unified_audio_tpu/utils/watchdog.py``:

* :func:`call_with_timeout` runs a blocking call on a daemon thread with a
  deadline and raises :class:`TimeoutError_` when it passes. Python cannot
  kill the thread: a call that never returns keeps its daemon thread.
* :class:`Heartbeat` and :class:`Watchdog`: producers beat, a monitor
  thread calls ``on_stall(name, age)`` when a beat is older than its limit
  (a wedged data pipeline, a hung device transfer) instead of letting a
  job hang silently.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Optional


class TimeoutError_(TimeoutError):
    pass


def call_with_timeout(fn: Callable, timeout: float, *args, **kwargs):
    """``fn(*args, **kwargs)`` within ``timeout`` seconds -> its result;
    its exception is raised here, a missed deadline raises
    :class:`TimeoutError_`."""
    q: queue.Queue = queue.Queue()

    def run():
        try:
            q.put((True, fn(*args, **kwargs)))
        except Exception as e:  # handed to the caller
            q.put((False, e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError_(f"{fn!r} exceeded {timeout}s")
    ok, result = q.get()
    if not ok:
        raise result
    return result


class Heartbeat:
    """The time of the last :meth:`beat`, read as :meth:`age` seconds."""

    def __init__(self):
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def beat(self):
        with self._lock:
            self._last = time.monotonic()

    def age(self) -> float:
        with self._lock:
            return time.monotonic() - self._last


class Watchdog:
    """Monitors named heartbeats; calls ``on_stall(name, age)`` when one
    goes quiet for longer than its limit, then restarts that beat so the
    alarm repeats once a limit at most. ``stalls`` counts the alarms by
    name. Use as a context manager."""

    def __init__(self, on_stall: Optional[Callable[[str, float], None]] = None,
                 poll_interval: float = 1.0):
        self._limits: Dict[str, float] = {}
        self._beats: Dict[str, Heartbeat] = {}
        self._on_stall = on_stall or (
            lambda name, age: print(f"[watchdog] '{name}' stalled {age:.1f}s")
        )
        self._poll = poll_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stalls: Dict[str, int] = {}

    def register(self, name: str, limit_seconds: float) -> Heartbeat:
        hb = Heartbeat()
        self._beats[name] = hb
        self._limits[name] = limit_seconds
        self.stalls[name] = 0
        return hb

    def _loop(self):
        while not self._stop.wait(self._poll):
            for name, hb in list(self._beats.items()):
                age = hb.age()
                if age > self._limits[name]:
                    self.stalls[name] += 1
                    self._on_stall(name, age)
                    hb.beat()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
