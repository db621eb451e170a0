"""The reader of ``graph_step_share.serve``: the program's
``engine.graph_steps`` counter over the steps of its ``engine.step`` spans,
on a fake recorder export; None where the program counts no replay."""
import pytest

from portbench.tests.test_portbench_program import _program, _reader


def _steps(counts):
    return _program(("engine.step", 0, 4, {"n": 1}, None),
                    ("engine.step", 5, 9, {"n": 255}, None),
                    ("engine.step", 10, 12, {"n": 16}, None),
                    counts=counts)


def test_share_of_the_profiled_steps_replayed():
    read = _reader("graph_step_share.serve").read
    assert read({"program": _steps({"engine.graph_steps": 271})}) == \
        pytest.approx(271 / 272)
    assert read({"program": _steps({"engine.graph_steps": 272})}) == 1.0


def test_none_without_the_counter_or_the_steps():
    """A program without graph replays (the counter absent), without the
    recorder, or with no step profiled reads None."""
    read = _reader("graph_step_share.serve").read
    assert read({"program": _steps({})}) is None
    assert read({"program": None}) is None
    assert read({"program": _program(
        ("engine.admit", 0, 4, {"admitted": 1, "waves": 1}, None),
        counts={"engine.graph_steps": 3})}) is None
