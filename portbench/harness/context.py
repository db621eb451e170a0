"""What a driver gets: the run's arguments, its cell's and configuration's
parameters, the reference module, and the spans and counts it records for
the per-layer readers."""
from __future__ import annotations

import time
from contextlib import contextmanager

from . import trace


class Run:
    def __init__(self, torch, args, cell: dict, config: dict, entry: dict,
                 reference, device: str = "cuda"):
        self.torch = torch
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.cell, self.config, self.entry = cell, config, entry
        self.reference = reference
        self.device = device
        # read by the per-layer metrics: spans [(name, seconds, attrs)],
        # counts {name: number}, the profiled part of the window
        self.records = {"spans": [], "counts": {}, "profiled": None}

    def generator(self, salt: int = 0):
        """A generator on the card seeded from ``--seed`` (and ``salt``,
        for draws that must not share a stream)."""
        g = self.torch.Generator(device=self.device)
        return g.manual_seed((self.seed * 1000003 + salt) % (2 ** 63))

    @contextmanager
    def span(self, name: str, **attrs):
        """In a traced run, a host span around a call into a layer, closed
        by a synchronize (and a profiler range); in a timed run, nothing."""
        if not self.trace:
            yield
            return
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(trace.SPAN + name):
            yield
            self.sync()
        self.records["spans"].append((name, time.perf_counter() - t0,
                                      attrs))

    def sync(self) -> None:
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def count(self, name: str, value) -> None:
        c = self.records["counts"]
        c[name] = c.get(name, 0) + value

    def profiled(self):
        """A profiler over the ``with`` body, kept for the readers."""
        p = trace.Profiled(self.torch)
        self.records["profiled"] = p
        return p
