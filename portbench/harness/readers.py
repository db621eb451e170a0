"""What the per-layer metrics' readers share: spans, counts and the
profiled part of a traced run, reduced to one number or to None when there
is nothing to read (never a 0 for a share of a roofline or a peak)."""
from __future__ import annotations

from .peaks import PEAK_OPS_S
from .stats import percentile


def spans(rec, name):
    return [(s, a) for n, s, a in rec["spans"] if n == name]


def ms_per_span(rec, name):
    """Mean milliseconds of the spans named ``name``."""
    got = spans(rec, name)
    return 1e3 * sum(s for s, _ in got) / len(got) if got else None


def ms_per_unit(rec, name, attr):
    """Milliseconds of the ``name`` spans per unit of their ``attr``."""
    got = spans(rec, name)
    units = sum(a[attr] for _, a in got)
    return 1e3 * sum(s for s, _ in got) / units if units else None


def host_calls_in(rec, span_name, calls):
    """Host calls named one of ``calls`` inside the profiled ``span_name``
    ranges."""
    prof = rec["profiled"]
    if prof is None:
        return None
    ranges = sorted((a, b) for n, a, b in prof.spans if n == span_name)
    if not ranges:
        return None
    hits = 0
    for name, a, _ in prof.host:
        if name in calls and any(lo <= a <= hi for lo, hi in ranges):
            hits += 1
    return hits


def roofline_pct(rec, least_key, calls_key, names):
    """100 x the least time of the counted calls over the device time of
    the profiled records named like ``names``; where the profiler kept
    fewer records than calls were made, the least time of as many calls
    (at the mean per call)."""
    prof, c = rec["profiled"], rec["counts"]
    if prof is None or not c.get(calls_key):
        return None
    got = prof.records(names)
    if not got:
        return None
    least = c[least_key] * min(1.0, len(got) / c[calls_key])
    return 100.0 * least / sum(s for _, s in got)


def idle_pct(rec):
    prof = rec["profiled"]
    if prof is None:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)


def mfu_pct(rec, parts):
    """100 x the sum over ``parts`` {count key: precision} of the counted
    model operations over that precision's peak, over the window."""
    c = rec["counts"]
    need = sum(c.get(k, 0) / PEAK_OPS_S[p] for k, p in parts.items())
    if not need or not rec.get("window_s"):
        return None
    return 100.0 * need / rec["window_s"]


def p95(values):
    return percentile(values, 95.0) if values else None
