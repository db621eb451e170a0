"""The closed-loop client scheduler against a fake engine with a fake
clock: every client keeps one utterance in flight, segments are admitted
first come first served, and a stall inside the window lowers the rate and
raises the tail."""
import itertools
from dataclasses import dataclass

import numpy as np
import pytest

from portbench.harness import closed_loop, stats


@dataclass
class Req:
    uid: int
    steps: int


@dataclass
class Res:
    uid: int


class FakeEngine:
    """Fixed decode lengths over ``num_slots`` slots; each step advances a
    fake clock by ``step_s`` (``stall_at``: one step that takes longer)."""

    def __init__(self, clock, num_slots=4, step_s=0.01, stall_at=None,
                 stall_s=1.0):
        self.clock, self.num_slots = clock, num_slots
        self.step_s, self.stall_at, self.stall_s = step_s, stall_at, stall_s
        self.slots, self.steps_done, self.staged = {}, 0, set()
        self.admission_order = []

    def admit_many(self, reqs):
        free = self.num_slots - len(self.slots)
        got = [r.uid for r in reqs[:free]]
        for r in reqs[:free]:
            self.slots[r.uid] = r.steps
        self.admission_order += got
        return got

    def step(self, n, generator=None):
        for _ in range(n):
            self.steps_done += 1
            self.clock.t += (self.stall_s if self.steps_done == self.stall_at
                             else self.step_s)
            for uid in self.slots:
                self.slots[uid] -= 1

    def prestage(self, reqs):
        self.staged |= {r.uid for r in reqs}

    def harvest(self):
        done = [u for u, rem in self.slots.items() if rem <= 0]
        for u in done:
            del self.slots[u]
        return [Res(u) for u in done]


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def chunks(remaining, poll):
    out = []
    while remaining > 0:
        c = min(poll, 1 << (remaining.bit_length() - 1))
        out.append(c)
        remaining -= c
    return out


def serve(stall_at=None, clients=6, turns=40):
    clock = Clock()
    uid = itertools.count()
    eng = FakeEngine(clock, stall_at=stall_at)

    def requests(utt):
        n = -(-utt.n_samples // 100)
        return [Req(next(uid), 5) for _ in range(n)]

    finished = []
    loop = closed_loop.ClosedLoop(
        clients, closed_loop.utterance_plan(7, 6, 0.5, 3.0,
                                            {"se": 0.5, "tse": 0.5}, 0.5),
        100, requests, finished.append, lambda r: r.steps, clock)
    loop.start()
    for _ in range(turns):
        closed_loop.cycle(eng, loop, None, 4, chunks,
                          lambda *a, **k: __import__("contextlib")
                          .nullcontext())
    return loop, eng, finished, clock.t


def test_every_client_keeps_one_utterance_in_flight():
    loop, eng, finished, _ = serve()
    assert len(loop.sent) == len(loop.completed) + 6
    in_flight = [u for u in loop.sent if u.done is None]
    assert sorted(u.client for u in in_flight) == list(range(6))
    assert finished == loop.completed
    for u in loop.completed:
        assert u.done >= u.sent and len(u.outputs) == len(u.requests)


def test_first_come_first_served():
    loop, eng, _, _ = serve()
    order = [r.uid for u in loop.sent for r in u.requests]
    assert eng.admission_order == order[:len(eng.admission_order)]


def test_stall_lowers_rate_and_raises_tail():
    loop0, _, _, t0 = serve()
    loop1, _, _, t1 = serve(stall_at=30)
    work0 = sum(u.n_samples for u in loop0.completed)
    work1 = sum(u.n_samples for u in loop1.completed)
    assert work0 == work1  # the same work, in the same order
    assert stats.rate(work1, t1) < stats.rate(work0, t0)
    lat0 = [u.latency for u in loop0.completed]
    lat1 = [u.latency for u in loop1.completed]
    assert stats.percentile(lat1, 95) > stats.percentile(lat0, 95) + 0.5


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plan_keeps_the_work_of_each_block(seed):
    block = 8
    ref = list(itertools.islice(closed_loop.utterance_plan(
        0, block, 1.0, 20.0, {"se": 0.75, "tse": 0.25}, 0.25), 3 * block))
    got = list(itertools.islice(closed_loop.utterance_plan(
        seed, block, 1.0, 20.0, {"se": 0.75, "tse": 0.25}, 0.25),
        3 * block))
    for k in range(3):
        a, b = ref[k * block:(k + 1) * block], got[k * block:(k + 1) * block]
        assert sorted(x[0] for x in a) == sorted(x[0] for x in b)
        assert sorted(x[1] for x in b) == ["se"] * 6 + ["tse"] * 2
        assert sum(x[2] for x in b) == 2
    assert got != ref
    lengths = sorted(x[0] for x in got[:block])
    assert lengths[0] > 1.0 and lengths[-1] < 20.0


def test_segments_wrap_pad():
    x = np.arange(7, dtype=np.float32)
    s = closed_loop.segments(x, 3)
    assert s.tolist() == [[0, 1, 2], [3, 4, 5], [6, 0, 1]]
