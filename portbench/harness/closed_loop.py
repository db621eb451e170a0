"""A closed loop of clients over a continuous-batching engine.

Each client sends one utterance, cut into fixed-length segments (engine
requests), and sends its next as soon as the last of them has come back
and been finished (detokenized). The utterances come from
``utterance_plan``: every seed gets the same lengths, tasks and greedy
shares, block by block, in its own order, so a seed changes the order of
the work and never its amount.

``cycle`` is one turn of the serving loop: admit what the free slots take,
decode in the engine's chunks up to the next completion (staging the
queue's inputs during the first chunk), harvest, finish what completed.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class Utterance:
    index: int
    n_samples: int
    task: str
    greedy: bool
    client: int = -1
    sent: float = 0.0
    done: Optional[float] = None
    requests: list = field(default_factory=list)
    outputs: Dict[int, object] = field(default_factory=dict)
    wav: Optional[np.ndarray] = None

    @property
    def latency(self) -> float:
        return self.done - self.sent


def utterance_plan(seed: int, block: int, min_s: float, max_s: float,
                   shares: Dict[str, float], greedy_share: float):
    """Endless (seconds, task, greedy): blocks of ``block`` utterances whose
    lengths are the block's quantiles of a log-uniform law over [min_s,
    max_s], whose tasks and greedy flags keep their shares exactly; each
    attribute permuted per block from ``seed``."""
    rng = np.random.default_rng(seed)
    q = (np.arange(block) + 0.5) / block
    lengths = np.exp(np.log(min_s) + q * (np.log(max_s) - np.log(min_s)))
    tasks: List[str] = []
    for task, share in shares.items():
        tasks += [task] * int(round(share * block))
    tasks = (tasks + [next(iter(shares))] * block)[:block]
    n_greedy = int(round(greedy_share * block))
    greedy = np.arange(block) < n_greedy
    while True:
        li, ti, gi = (rng.permutation(block) for _ in range(3))
        for k in range(block):
            yield float(lengths[li[k]]), tasks[ti[k]], bool(greedy[gi[k]])


class ClosedLoop:
    """``make_requests(utt)`` -> the utterance's engine requests (uids
    unique); ``finish(utt)`` runs when all of them are back."""

    def __init__(self, clients: int, plan, sample_rate: int,
                 make_requests: Callable, finish: Callable,
                 steps_of: Callable, clock=time.perf_counter):
        self.plan, self.sr = plan, sample_rate
        self.make_requests, self.finish = make_requests, finish
        self.steps_of, self.clock = steps_of, clock
        self.clients = clients
        self.pending: list = []
        self.by_uid: Dict[int, Utterance] = {}
        self.live: Dict[int, list] = {}  # uid -> [remaining, steps done]
        self.sent: List[Utterance] = []
        self.completed: List[Utterance] = []

    def start(self):
        for c in range(self.clients):
            self._send(c)

    def _send(self, client: int):
        seconds, task, greedy = next(self.plan)
        utt = Utterance(len(self.sent), int(round(seconds * self.sr)), task,
                        greedy, client)
        utt.requests = self.make_requests(utt)
        for r in utt.requests:
            self.by_uid[r.uid] = utt
        self.pending.extend(utt.requests)
        utt.sent = self.clock()
        self.sent.append(utt)

    def admitted(self, uids):
        got = set(uids)
        for r in self.pending:
            if r.uid in got:
                self.live[r.uid] = [self.steps_of(r), 0]
        self.pending = [r for r in self.pending if r.uid not in got]

    def next_completion(self) -> int:
        return min(rem for rem, _ in self.live.values())

    def advance(self, n: int):
        for rec in self.live.values():
            rec[0] -= n
            rec[1] += n

    def on_results(self, results) -> List[Utterance]:
        done = []
        for r in results:
            self.live.pop(r.uid, None)
            utt = self.by_uid.pop(r.uid)
            utt.outputs[r.uid] = r
            if len(utt.outputs) == len(utt.requests):
                self.finish(utt)
                utt.done = self.clock()
                self.completed.append(utt)
                done.append(utt)
                self._send(utt.client)
        return done


def cycle(eng, loop: ClosedLoop, generator, poll_interval: int,
          chunks: Callable, span: Callable, on_chunk=None, on_admit=None):
    """One turn: admit, decode to the next completion, harvest, finish.
    ``span(name, **attrs)`` wraps each call into the engine;
    ``on_admit(uids)`` sees the admitted requests, ``on_chunk(n)`` each
    chunk before it runs."""
    with span("admit"):
        uids = eng.admit_many(loop.pending)
    if on_admit is not None:
        on_admit(uids)
    loop.admitted(uids)
    if not loop.live:
        raise RuntimeError("the engine admitted nothing and nothing is live")
    for j, c in enumerate(chunks(loop.next_completion(), poll_interval)):
        if on_chunk is not None:
            on_chunk(c)
        with span("decode_step", steps=c):
            eng.step(c, generator)
        loop.advance(c)
        if j == 0 and loop.pending:
            eng.prestage(loop.pending)
    with span("harvest"):
        results = eng.harvest()
    return loop.on_results(results)


def segments(wav: np.ndarray, seg_len: int) -> np.ndarray:
    """(N,) -> (ceil(N / seg_len), seg_len), wrap-padded (UniSE's
    ``_segment``)."""
    n = math.ceil(len(wav) / seg_len)
    return np.pad(wav, (0, n * seg_len - len(wav)), mode="wrap").reshape(
        n, seg_len)
