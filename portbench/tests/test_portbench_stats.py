"""Rates, tails, spreads and the idle arithmetic on synthetic timelines."""
import statistics

import pytest

from portbench.harness import readers, stats, trace


class FakeTorch:
    class autograd:
        class DeviceType:
            CUDA = "cuda"


def profiled(kernels, window, spans=(), host=()):
    p = trace.Profiled(FakeTorch)
    p.kernels = [(n, a, b) for n, a, b in kernels]
    p.window_ns = window
    p.spans, p.host = list(spans), list(host)
    return p


def test_busy_merges_overlaps_and_clips_to_window():
    p = profiled([("k", 0, 10), ("k", 5, 20), ("k", 30, 40), ("k", 95, 120)],
                 (0, 100))
    assert p.busy_s() == pytest.approx((20 + 10 + 5) * 1e-9)
    assert readers.idle_pct({"profiled": p}) == pytest.approx(65.0)
    assert p.gaps()[0] == (40, 95)


def test_gap_labels_follow_spans_and_host_ops():
    p = profiled([("k", 0, 10), ("k", 50, 60)], (0, 60),
                 spans=[("decode_step", 5, 55)],
                 host=[("aten::mm", 20, 40), ("cudaLaunchKernel", 0, 60)])
    b = p.breakdown()
    assert b["idle_gaps"][0][0] == "decode_step: aten::mm"
    assert b["device_ops"] == [["k", pytest.approx(20e-9)]]


def test_percentile_and_rate():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.rate(10.0, 4.0) == 2.5
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_spread_is_python_quartiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / 10.05)


def test_mfu_and_roofline_readers():
    rec = {"counts": {"f": 67e12 * 0.5, "least": 2.0, "calls": 4},
           "window_s": 1.0,
           "profiled": profiled([("kern_a", 0, int(4e9)), ("other", 0, 5)],
                                (0, int(5e9)))}
    assert readers.mfu_pct(rec, {"f": "fp32"}) == pytest.approx(50.0)
    # one record found of four calls: the least time of one call
    assert readers.roofline_pct(rec, "least", "calls", ("kern",)) == \
        pytest.approx(100 * 0.5 / 4.0)
    rec["counts"] = {}
    assert readers.mfu_pct(rec, {"f": "fp32"}) is None
    assert readers.roofline_pct(rec, "least", "calls", ("kern",)) is None
