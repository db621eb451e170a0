"""What the readers of the program's own spans and counters share.

Two sources, each reduced to one number or to None where the program
recorded nothing (a program without the recorder, or without the span):

* the recorder of ``unified_audio_tpu_torch/utils/profiling.py``, read in
  the benchmark's own process once the window has closed
  (:func:`export_of`). The recorder is on while a ``torch.profiler`` runs,
  so in a traced run it holds the spans and counts of the profiled part of
  the window;
* the program's spans on the profiler's clock (:func:`trace_of`): each
  span is a profiler range named ``ua:<span>`` beside the runtime calls
  and the device records. :class:`ProgramTrace` reads the profiler's
  Kineto events once more and gives each device record to the program
  spans open around the runtime call that launched it, on that call's
  thread: the record and the call share a CUDA correlation id. A call on a
  thread with no program span open (the autograd engine's thread, which
  launches the backward pass while the dispatching thread waits in
  ``backward()``) belongs to the spans open on the dispatching thread (the
  one that holds ``pb:window``) at that moment. User annotations on the
  device side (the profiler's copies of ``pb:`` and other
  ``record_function`` ranges) are ranges, not work: they are no device
  records here.

The first reading of a run prints one line on standard error: the share
of the profiled device time that falls to a program span, the device
seconds of each span, where the synchronizing calls inside program spans
were made, and the longest idle gaps labelled ``<benchmark span> >
<innermost program span>: <host op>`` from the dispatching thread.
"""
from __future__ import annotations

import sys
from collections import Counter, defaultdict

from . import trace

PROGRAM = "ua:"  # the program's spans
RECORDER_MODULE = "unified_audio_tpu_torch.utils.profiling"
RUNTIME = ("cuda", "cu")  # the CUDA API calls made on the host
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def _call(ev, what, default=None):
    fn = getattr(ev, what, None)
    return default if fn is None else fn()


def _open_at(ranges, points):
    """``ranges`` [(name, start, end)] of one thread, nested as a thread's
    ranges are; ``points`` [(time, key)] -> {key: (names of the ranges
    open at that time, outermost first)}."""
    ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while i < len(ranges) and ranges[i][1] <= t:
            while stack and stack[-1][2] <= ranges[i][1]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[key] = tuple(r[0] for r in stack)
    return out


class ProgramTrace(trace.Profiled):
    """The profiled events sorted as :class:`trace.Profiled` sorts them,
    and besides: ``owners`` beside ``kernels`` (the program spans each
    record belongs to, outermost first), ``host_tids`` beside ``host``,
    ``program`` [(name, start, end, thread)] of the program's spans,
    ``runtime`` [(name, start, end, thread, spans open around it)] of the
    host's CUDA calls and ``thread`` the dispatching thread."""

    def __init__(self, events, cuda):
        super().__init__(None)
        self.owners, self.host_tids, self.program, self.runtime = \
            [], [], [], []
        self.thread = None
        self._ingest(list(events), cuda)

    def _ingest(self, events, cuda):
        ranges = {ev.name() for ev in events if ev.device_type() != cuda
                  and _call(ev, "is_user_annotation", False)}
        device, launches = [], []
        by_thread = defaultdict(list)
        for ev in events:
            name = ev.name()
            a = trace._ns(ev, "start")
            b = a + trace._ns(ev, "duration")
            if ev.device_type() == cuda:
                if not (name in ranges
                        or name.startswith((trace.SPAN, PROGRAM))
                        or _call(ev, "is_user_annotation", False)):
                    device.append((name, a, b, _call(ev, "correlation_id")))
                continue
            tid = _call(ev, "start_thread_id")
            if name == trace.WINDOW:
                self.window_ns, self.thread = (a, b), tid
            elif name.startswith(trace.SPAN):
                self.spans.append((name[len(trace.SPAN):], a, b))
            elif name.startswith(PROGRAM):
                self.program.append((name[len(PROGRAM):], a, b, tid))
                by_thread[tid].append((name[len(PROGRAM):], a, b))
            else:
                self.host.append((name, a, b))
                self.host_tids.append(tid)
                if name.startswith(RUNTIME):
                    launches.append((name, a, b, tid,
                                     _call(ev, "correlation_id")))
        if self.window_ns is None:
            raise RuntimeError("the profiler lost the window's range")
        paths = {}
        for tid in {c[3] for c in launches}:
            paths.update(_open_at(by_thread.get(tid, []), [
                (c[1], k) for k, c in enumerate(launches) if c[3] == tid]))
        paths.update(_open_at(by_thread.get(self.thread, []), [
            (c[1], k) for k, c in enumerate(launches)
            if not paths[k] and c[3] != self.thread]))
        corr = {}
        for k, (name, a, b, tid, cid) in enumerate(launches):
            self.runtime.append((name, a, b, tid, paths[k]))
            if cid:
                corr[cid] = paths[k]
        for name, a, b, cid in device:
            self.kernels.append((name, a, b))
            self.owners.append(corr.get(cid, ()) if cid else ())

    def merged(self, keep=None):
        """The device records' intervals inside the window, merged (only
        the records whose program spans ``keep(owners)`` accepts, when
        given)."""
        lo, hi = self.window_ns
        ivs = sorted((max(a, lo), min(b, hi)) for k, (_, a, b)
                     in enumerate(self.kernels) if b > lo and a < hi
                     and (keep is None or keep(self.owners[k])))
        out = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def device_s(self, span: str = None) -> float:
        """Device seconds (merged) of the records that belong to program
        span ``span`` (to any program span when None)."""
        keep = bool if span is None else (lambda path: span in path)
        return sum(b - a for a, b in self.merged(keep)) * 1e-9

    def program_ranges(self, name: str) -> list:
        """(start, end) of the program's ``name`` spans in the window."""
        return [(a, b) for n, a, b, _ in self.program if n == name]

    def syncs(self) -> list:
        """The host's synchronizing CUDA calls inside a program span:
        (call, the spans open around it)."""
        return [(n, path) for n, _, _, _, path in self.runtime
                if n in SYNC_CALLS and path]

    def sync_sites(self) -> Counter:
        """The synchronizing calls inside program spans by (innermost
        program span, outermost host operation around the call on its
        thread: the call into torch that synchronized)."""
        calls = [(a, tid, path) for n, a, _, tid, path in self.runtime
                 if n in SYNC_CALLS and path]
        out = Counter()
        for tid in {c[1] for c in calls}:
            ops = [h for h, t in zip(self.host, self.host_tids)
                   if t == tid and not h[0].startswith(RUNTIME)]
            points = [(a, k) for k, (a, t, _) in enumerate(calls) if t == tid]
            around = _open_at(ops, points)
            for _, k in points:
                out[(calls[k][2][-1], (around[k] or ("",))[0])] += 1
        return out

    def _label(self, t) -> str:
        """``<benchmark span> > <innermost program span>: <host op>`` at
        ``t``, the program span and the host operation taken from the
        dispatching thread."""
        def innermost(items):
            inside = [(b - a, n) for n, a, b in items if a <= t <= b]
            return min(inside)[1] if inside else None

        def mine(tid):
            return self.thread is None or tid is None or tid == self.thread

        where = innermost(self.spans) or "between spans"
        program = innermost((n, a, b) for n, a, b, tid in self.program
                            if mine(tid))
        op = innermost(h for h, tid in zip(self.host, self.host_tids)
                       if mine(tid))
        if program is not None:
            where = f"{where} > {program}"
        return where if op is None else f"{where}: {op}"

    def summary(self, top: int = 5) -> str:
        """One line: the share of the window's device time that falls to
        a program span, the device seconds of each program span, the
        synchronizing calls inside program spans by where they were made,
        and the longest idle gaps."""
        busy = self.busy_s()
        share = 100.0 * self.device_s() / busy if busy else 0.0
        names = sorted({n for n, *_ in self.program})
        by_span = {n: round(self.device_s(n), 6) for n in names}
        syncs = {f"{span} / {op}": n
                 for (span, op), n in self.sync_sites().most_common()}
        gaps = self.breakdown(top)["idle_gaps"]
        return (f"profiled: {share:.2f}% of {busy:.6f} s of device time in "
                f"a {self.window_s:.6f} s window falls to a program span; "
                f"device s by program span: {by_span}; synchronizing calls "
                f"in program spans (span / call into torch): {syncs}; "
                f"longest idle gaps: {gaps}")


def trace_of(rec):
    """The profiled part of the run read for the program's spans (read
    once, kept in ``rec``), or None where nothing was profiled."""
    if "program_trace" not in rec:
        prof = rec.get("profiled")
        kineto = getattr(getattr(getattr(prof, "_prof", None), "profiler",
                                 None), "kineto_results", None)
        got = None
        if kineto is not None:
            got = ProgramTrace(kineto.events(),
                               prof.torch.autograd.DeviceType.CUDA)
            print(got.summary(), file=sys.stderr)
        rec["program_trace"] = got
    return rec["program_trace"]


def export_of(rec):
    """The program recorder's export (kept in ``rec``), or None where the
    program has no recorder or it recorded nothing."""
    if "program" not in rec:
        mod = sys.modules.get(RECORDER_MODULE)
        recorder = getattr(mod, "RECORDER", None)
        got = recorder.export() if recorder is not None else None
        rec["program"] = got if got and (got["spans"] or got["counts"]) \
            else None
    return rec["program"]


def spans(rec, name):
    """The recorder's ``name`` spans, or None."""
    prog = export_of(rec)
    if not prog:
        return None
    return [s for s in prog["spans"] if s["name"] == name] or None


def counter(rec, name):
    prog = export_of(rec)
    return prog["counts"].get(name) if prog else None


def host_ms_per_unit(rec, name, attr):
    """Host milliseconds of the recorder's ``name`` spans per unit of their
    ``attr``."""
    got = spans(rec, name)
    if not got:
        return None
    units = sum(s["attrs"][attr] for s in got)
    ns = sum(s["end_ns"] - s["start_ns"] for s in got)
    return 1e-6 * ns / units if units else None


def ranged(rec, span):
    """The program trace where it holds ``span`` ranges, else None."""
    got = trace_of(rec)
    return got if got is not None and got.program_ranges(span) else None


def device_ms_per(rec, span, per):
    """Device milliseconds (merged) of the profiled records that belong to
    program span ``span``, over the number of profiled ``per`` spans."""
    got = ranged(rec, span)
    if got is None:
        return None
    n = len(got.program_ranges(per))
    return 1e3 * got.device_s(span) / n if n else None


def idle_pct_in(rec, span):
    """The share of the profiled ``span`` intervals (the host's) in which
    no device record ran."""
    got = ranged(rec, span)
    if got is None:
        return None
    ranges = got.program_ranges(span)
    total = sum(b - a for a, b in ranges)
    if not total:
        return None
    busy = got.merged()
    covered = sum(max(0, min(b, d) - max(a, c))
                  for a, b in ranges for c, d in busy)
    return 100.0 * (1.0 - covered / total)
