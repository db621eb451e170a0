"""``torch.profiler`` over a steady part of a run, reduced to what the
benchmark reports: the device's busy time (the union of its records'
intervals; copied from ``chip_smoke.py busy_share``), device time by
kernel name, and the idle gaps labelled by the benchmark's own span the
host was in (``record_function`` names starting with ``pb:``) and the host
operation under it.

The raw records are read from the profiler's Kineto results, without the
event tree that ``prof.events()`` would build.
"""
from __future__ import annotations

import time
from collections import defaultdict

SPAN = "pb:"  # the benchmark's own ranges
WINDOW = "pb:window"


def _ns(ev, what):
    fn = getattr(ev, what + "_ns", None)
    if fn is not None:
        return fn()
    return getattr(ev, what + "_us")() * 1000


class Profiled:
    """Profile the ``with`` body (the card synchronized at both ends); then
    ``kernels`` [(name, start ns, end ns)] of the device, ``host``
    [(name, start, end)] of the host's operations, ``spans`` of the
    benchmark's ranges and ``window_ns`` (start, end) of the body."""

    def __init__(self, torch):
        self.torch = torch
        self.kernels, self.host, self.spans = [], [], []
        self.window_ns = None
        self.host_s = None

    def __enter__(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._rf = torch.profiler.record_function(WINDOW)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch = self.torch
        torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        cuda = self.torch.autograd.DeviceType.CUDA
        results = self._prof.profiler.kineto_results
        for ev in results.events():
            name = ev.name()
            a = _ns(ev, "start")
            b = a + _ns(ev, "duration")
            if ev.device_type() == cuda:
                if not name.startswith(SPAN):  # gpu_user_annotation ranges
                    self.kernels.append((name, a, b))
            elif name == WINDOW:
                self.window_ns = (a, b)
            elif name.startswith(SPAN):
                self.spans.append((name[len(SPAN):], a, b))
            else:
                self.host.append((name, a, b))
        if self.window_ns is None:
            raise RuntimeError("the profiler lost the window's range")

    @property
    def window_s(self) -> float:
        a, b = self.window_ns
        return (b - a) * 1e-9

    def merged(self):
        """The device records' intervals inside the window, merged."""
        lo, hi = self.window_ns
        ivs = sorted((max(a, lo), min(b, hi)) for _, a, b in self.kernels
                     if b > lo and a < hi)
        out = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) * 1e-9

    def by_name(self) -> dict:
        """kernel name -> [device seconds, records]."""
        out = defaultdict(lambda: [0.0, 0])
        for name, a, b in self.kernels:
            rec = out[name]
            rec[0] += (b - a) * 1e-9
            rec[1] += 1
        return dict(out)

    def records(self, names) -> list:
        """(name, seconds) of the device records whose name holds one of
        ``names``."""
        return [(n, (b - a) * 1e-9) for n, a, b in self.kernels
                if any(k in n for k in names)]

    def gaps(self):
        """Idle intervals of the window, longest first: (start, end)."""
        lo, hi = self.window_ns
        edges, prev = [], lo
        for a, b in self.merged():
            if a > prev:
                edges.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            edges.append((prev, hi))
        return sorted(edges, key=lambda g: g[0] - g[1])

    def _label(self, t) -> str:
        def innermost(items):
            inside = [(b - a, n) for n, a, b in items if a <= t <= b]
            return min(inside)[1] if inside else None
        where = innermost(self.spans) or "between spans"
        op = innermost(self.host)
        return where if op is None else f"{where}: {op}"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n[:120], s) for n, (s, _) in self.by_name().items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = []
        for a, b in self.gaps()[:top]:
            gaps.append([self._label((a + b) / 2)[:120], (b - a) * 1e-9])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}
