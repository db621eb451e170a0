"""The profiler's events read into device records, program spans and gap
labels, and the readers of the program's own spans and counters
(``harness/program.py``), on synthetic Kineto-like events."""
import sys
import types

import pytest

from portbench.harness import program
from portbench.tests.test_portbench_stats import FakeTorch, profiled


class Ev:
    """A Kineto event as the profiler's results give it."""

    def __init__(self, name, a, b, device="cpu", tid=1, corr=0,
                 user=False):
        self._name, self._a, self._b = name, a, b
        self._device, self._tid, self._corr = device, tid, corr
        self._user = user

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._user


def ingest(events):
    return program.ProgramTrace(events, FakeTorch.autograd.DeviceType.CUDA)


class FakeProfiler:
    """What ``harness/trace.py Profiled`` keeps of a profiler run."""

    def __init__(self, events):
        self.torch = FakeTorch
        results = types.SimpleNamespace(events=lambda: list(events))
        self._prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=results))


def rng(name, a, b, tid=1):
    """A host range of ``record_function`` (a user annotation)."""
    return Ev(name, a, b, tid=tid, user=True)


def launch(a, corr, tid=1, name="cudaLaunchKernel"):
    return Ev(name, a, a + 5, tid=tid, corr=corr)


def kernel(name, a, b, corr):
    return Ev(name, a, b, device="cuda", corr=corr)


def test_device_annotations_are_not_device_records():
    """The device-side copies of ``pb:``, ``ua:`` and other user ranges
    (flagged or not) change neither the busy time nor ``device_ops``."""
    events = [rng("pb:window", 0, 1000), rng("pb:decode_step", 0, 1000),
              rng("ua:engine.step", 10, 900), rng("Optimizer.step#x", 0, 5),
              launch(20, 1),
              kernel("pb:decode_step", 0, 1000, 0),
              kernel("ua:engine.step", 100, 900, 0),
              Ev("ua:engine.step.lm", 100, 800, device="cuda", user=True),
              kernel("Optimizer.step#x", 0, 1000, 0),
              kernel("k", 100, 200, 1)]
    p = ingest(events)
    assert p.busy_s() == pytest.approx(100e-9)
    assert p.breakdown()["device_ops"] == [["k", pytest.approx(100e-9)]]
    assert [n for n, *_ in p.program] == ["engine.step"]
    assert [n for n, *_ in p.host] == ["Optimizer.step#x",
                                       "cudaLaunchKernel"]


def test_records_go_to_the_innermost_span_of_their_launch():
    """A device record belongs to the program spans open around the call
    that launched it (same correlation id), on that call's thread, however
    late it runs; a call on a thread with no span open, to the spans of the
    dispatching thread at that moment; a launch outside every span gives
    no owner."""
    events = [rng("pb:window", 0, 1000),
              rng("ua:engine.step", 10, 100), rng("ua:engine.step.lm", 20, 50),
              rng("ua:data.stage", 0, 200, tid=2),
              launch(25, 7), launch(60, 8), launch(30, 9, tid=2),
              launch(300, 10, name="cudaMemcpyAsync"),
              launch(70, 11, tid=3),  # the autograd engine's thread
              kernel("a", 400, 410, 7), kernel("b", 410, 430, 8),
              kernel("c", 425, 440, 9), kernel("Memcpy DtoH", 500, 540, 10),
              kernel("grad", 600, 620, 11)]
    p = ingest(events)
    assert p.owners == [("engine.step", "engine.step.lm"), ("engine.step",),
                        ("data.stage",), (), ("engine.step",)]
    assert p.device_s("engine.step") == pytest.approx(50e-9)
    assert p.device_s("engine.step.lm") == pytest.approx(10e-9)
    assert p.device_s("data.stage") == pytest.approx(15e-9)
    assert p.device_s() == pytest.approx(60e-9)  # 400-440 merged, 600-620
    assert p.busy_s() == pytest.approx(100e-9)
    assert "60.00% of" in p.summary()
    assert p.program_ranges("engine.step") == [(10, 100)]


def test_gap_labels_carry_the_program_span_and_the_dispatch_thread():
    """An idle gap is labelled ``<benchmark span> > <innermost program
    span>: <host op>``, the program span and the host op taken from the
    thread that holds the window, not from a loader thread whose op is
    shorter."""
    events = [rng("pb:window", 0, 1000), rng("pb:decode_step", 0, 1000),
              rng("ua:engine.step", 0, 1000),
              rng("ua:engine.step.sample", 400, 700),
              rng("ua:data.stage", 500, 600, tid=2),
              Ev("aten::topk", 450, 650), Ev("aten::mm", 500, 600, tid=2),
              launch(10, 1), launch(660, 2),
              kernel("k", 0, 450, 1), kernel("k", 650, 1000, 2)]
    p = ingest(events)
    assert p.breakdown()["idle_gaps"][0][0] == \
        "decode_step > engine.step.sample: aten::topk"


def test_syncs_inside_program_spans():
    """Synchronizing calls inside a program span count, by their innermost
    span and the outermost host operation around them; the benchmark's own
    closing synchronize outside every span does not."""
    events = [rng("pb:window", 0, 1000), rng("pb:admit", 0, 600),
              rng("ua:engine.admit", 0, 500),
              rng("ua:engine.admit.frontend", 100, 200),
              Ev("aten::nonzero", 110, 140), Ev("aten::copy_", 115, 135),
              launch(120, 1, name="cudaStreamSynchronize"),
              launch(300, 2, name="cudaMemcpy"),
              launch(310, 3, name="cudaMemcpyAsync"),
              launch(550, 4, name="cudaDeviceSynchronize")]
    p = ingest(events)
    assert p.syncs() == [("cudaStreamSynchronize",
                          ("engine.admit", "engine.admit.frontend")),
                         ("cudaMemcpy", ("engine.admit",))]
    assert p.sync_sites() == {("engine.admit.frontend", "aten::nonzero"): 1,
                              ("engine.admit", ""): 1}
    assert "{'engine.admit.frontend / aten::nonzero': 1, 'engine.admit / ': " \
        "1}" in p.summary()


def _program(*spans, counts=None):
    out, ids = [], {}
    for k, (name, a, b, attrs, parent) in enumerate(spans, 1):
        ids[name] = k
        out.append({"id": k, "parent": ids.get(parent), "name": name,
                    "thread": 1, "start_ns": a, "end_ns": b,
                    "attrs": attrs})
    return {"spans": out, "counts": counts or {}}


def _reader(name):
    from portbench.harness import manifest
    return manifest.load_module(manifest.metric_path(name), "metrics." + name)


def test_serving_readers():
    """The five serving readers on one profiled wave: an admission whose
    frontend and prefill launch 30 and 20 ns of work with one sync inside,
    two steps of 3 profiled tokens launching 40 ns."""
    events = [rng("pb:window", 0, 2000), rng("ua:engine.admit", 0, 300),
              rng("ua:engine.admit.frontend", 10, 100),
              rng("ua:engine.admit.prefill", 100, 200),
              launch(20, 1), launch(110, 2),
              launch(150, 3, name="cudaStreamSynchronize"),
              rng("ua:engine.step", 400, 600), launch(410, 4),
              rng("ua:engine.step", 700, 900), launch(710, 5),
              launch(1900, 6, name="cudaDeviceSynchronize"),
              kernel("wavlm", 30, 60, 1), kernel("prefill", 120, 140, 2),
              kernel("k1", 420, 450, 4), kernel("k1", 720, 730, 5)]
    rec = {"profiled": FakeProfiler(events), "counts": {"profiled_steps": 3},
           "program": _program(("engine.step", 0, 4_000_000, {"n": 2}, None),
                               ("engine.step", 5_000_000, 7_000_000,
                                {"n": 2}, None),
                               ("engine.admit", 8_000_000, 9_000_000,
                                {"admitted": 2, "waves": 1}, None))}
    assert _reader("step_host_ms.serve").read(rec) == pytest.approx(1.5)
    assert _reader("step_device_ms.serve").read(rec) == \
        pytest.approx(1e3 * 40e-9 / 3)
    assert _reader("frontend_ms_per_wave.serve").read(rec) == \
        pytest.approx(30e-6)
    assert _reader("prefill_ms_per_wave.serve").read(rec) == \
        pytest.approx(20e-6)
    assert _reader("host_syncs_per_wave.serve").read(rec) == 1
    bare = {"profiled": rec["profiled"], "counts": rec["counts"],
            "program": None}
    none = {"profiled": None, "counts": {}, "program": None}
    for name in ("step_host_ms.serve", "step_device_ms.serve",
                 "frontend_ms_per_wave.serve", "prefill_ms_per_wave.serve",
                 "host_syncs_per_wave.serve"):
        assert _reader(name).read(none) is None, name
    # a program without the recorder: neither spans nor ranges
    old = {"profiled": profiled([("k", 0, 10)], (0, 100)),
           "counts": {"profiled_steps": 3}, "program": None}
    for name in ("step_host_ms.serve", "step_device_ms.serve",
                 "frontend_ms_per_wave.serve", "prefill_ms_per_wave.serve",
                 "host_syncs_per_wave.serve"):
        assert _reader(name).read(old) is None, name
    assert _reader("step_host_ms.serve").read(bare) is None


def test_training_readers():
    """The five training readers on two profiled steps: XLSR, BiCodec's
    tokenize and WavLM launching 40, 20 and 10 ns of work inside frozen
    intervals of 300 ns each, 70 of them busy; the loader's CPU seconds
    over the profiled steps (the recorder's ``unise.frozen`` spans)."""
    events = [rng("pb:window", 0, 2000)]
    for base, c in ((0, 1), (1000, 10)):
        events += [rng("ua:unise.frozen", base, base + 300),
                   rng("ua:bicodec.xlsr", base, base + 100),
                   rng("ua:bicodec.tokenize", base + 100, base + 200),
                   rng("ua:unise.frozen.wavlm", base + 200, base + 300),
                   launch(base + 10, c), launch(base + 110, c + 1),
                   launch(base + 210, c + 2),
                   kernel("x", base + 20, base + 60, c),
                   kernel("b", base + 120, base + 140, c + 1),
                   kernel("w", base + 220, base + 230, c + 2)]
    rec = {"profiled": FakeProfiler(events), "counts": {"steps": 4},
           "program": _program(*[("unise.frozen", k, k + 1, {}, None)
                                 for k in range(4)],
                               counts={"data.loader_cpu_s": 2.0})}
    ms = {n: _reader(n).read(rec) for n in (
        "xlsr_ms_per_step.train", "bicodec_tok_ms_per_step.train",
        "wavlm_ms_per_step.train", "frozen_idle_pct.train",
        "loader_cpu_ms_per_step.train")}
    assert ms == pytest.approx({
        "xlsr_ms_per_step.train": 40e-6, "bicodec_tok_ms_per_step.train":
        20e-6, "wavlm_ms_per_step.train": 10e-6,
        "frozen_idle_pct.train": 100 * (1 - 70 / 300),
        "loader_cpu_ms_per_step.train": 500.0})
    none = {"profiled": None, "counts": {"steps": 4}, "program": None}
    old = {"profiled": profiled([("k", 0, 10)], (0, 100)),
           "counts": {"steps": 4}, "program": None}
    for name in ms:
        assert _reader(name).read(none) is None, name
        assert _reader(name).read(old) is None, name


def test_program_records_read_once_and_absent_in_a_program_without_them(
        monkeypatch, capsys):
    """The profiler's events are read once a run, with one line on
    standard error; the recorder's export is taken from the program's
    module in the benchmark's process, and a program whose module has no
    recorder (or one that recorded nothing) gives None."""
    events = [rng("pb:window", 0, 1000), rng("ua:engine.step", 0, 500),
              launch(10, 1), kernel("k", 100, 200, 1)]
    rec = {"profiled": FakeProfiler(events)}
    got = program.trace_of(rec)
    assert program.trace_of(rec) is got
    assert got.device_s("engine.step") == pytest.approx(100e-9)
    err = capsys.readouterr().err
    assert err.count("profiled: 100.00% of") == 1
    assert program.trace_of({"profiled": None}) is None

    monkeypatch.setitem(sys.modules, program.RECORDER_MODULE,
                        types.ModuleType("profiling"))
    assert program.export_of({}) is None

    class Recorder:
        def __init__(self, out):
            self.out = out

        def export(self):
            return self.out

    mod = types.ModuleType("profiling")
    mod.RECORDER = Recorder({"spans": [], "counts": {}})
    monkeypatch.setitem(sys.modules, program.RECORDER_MODULE, mod)
    assert program.export_of({}) is None
    mod.RECORDER = Recorder(_program(("engine.step", 0, 2, {"n": 1}, None)))
    rec = {}
    assert program.spans(rec, "engine.step")[0]["attrs"] == {"n": 1}
    assert rec["program"]["spans"][0]["name"] == "engine.step"
