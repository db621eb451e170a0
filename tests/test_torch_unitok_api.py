"""The port's UniTok serving engine API against the JAX package's
``UniTokEngine``: displacing admission with stashed codes, ``step(n)``,
the owner mode and one device read per harvest and per drain. The port
has one schedule where the JAX engine has options (eager drain, dispatch
overshoot); greedy codes do not depend on the schedule, so the port's are
held to the JAX engine's under each of those options.

Mirrors, by name, tests of tests/test_unitok_engine.py (the JAX engine's
own, in the slow tier) on the tiny config of tests/test_torch_unitok.py
(codebook 17, 2 streams of 2 quantizers, hidden 32, 2 layers), fp32. Greedy
codes must equal the JAX engine's exactly. On the CPU the owner mode runs
the K1/K2 plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_common import random_variables
from test_torch_unitok import _jax_generate, port_unitok, tiny_cfg
from unified_audio_tpu.models.unitok.model import UniTokLM
from unified_audio_tpu.serve import unitok_engine as j_unitok
from unified_audio_tpu_torch.serve.unitok_engine import (UniTokEngine,
                                                         UniTokRequest)

KEY = jax.random.PRNGKey(3)
ENGINE_KW = dict(num_slots=4, block_size=16, max_frames=32,
                 feat_buckets=(8, 16))


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_cfg()
    jlm = UniTokLM(cfg)
    variables = jax.device_get(random_variables(
        jlm, 0, np.zeros((1, 3, cfg.text_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 6, cfg.num_codebooks), np.int32), seed=5))
    return cfg, jlm, variables, port_unitok(cfg, variables)


def jax_engine(lm, **kw):
    return j_unitok.UniTokEngine(lm[1], lm[2], **{**ENGINE_KW, **kw})


def port_engine(lm, **kw):
    return UniTokEngine(lm[3], **{**ENGINE_KW, **kw})


def displacing_requests(cls, cfg):
    rng = np.random.default_rng(9)
    return [cls(task_id=i % 6, num_frames=4 + i % 3,
                input_feats=rng.standard_normal(
                    (4, cfg.audio_dim)).astype(np.float32),
                do_sample=False, uid=700 + i) for i in range(9)]


def assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid].codes, want[uid].codes,
                                      err_msg=f"uid {uid}")


@pytest.fixture(scope="module")
def jax_displacing(lm):
    eng = jax_engine(lm)
    out = eng.run(displacing_requests(j_unitok.UniTokRequest, lm[0]), KEY)
    return out, eng.stats()


def test_displacing_deferred_drain(lm, jax_displacing):
    """9 requests through 4 slots displace finished slots without device
    reads and the stashes are fetched in one read, as in the JAX engine;
    the codes are the JAX engine's with its deferred drain and with its
    eager one. The port admits every signature's wave while slots last
    (JAX's one a round), so it prefills more waves in fewer rounds."""
    want, jst = jax_displacing
    eng = port_engine(lm)
    got = eng.run(displacing_requests(UniTokRequest, lm[0]))
    st = eng.stats()
    assert st["stash_fetches"] == jst["stash_fetches"] == 1
    assert st["requests_completed"] == 9 and st["blocks_held"] == 0
    for k in ("prefill_waves", "step_dispatches"):
        assert st[k] == jst[k], k
    eager_eng = jax_engine(lm, eager_drain=True)
    eager = eager_eng.run(displacing_requests(j_unitok.UniTokRequest, lm[0]),
                          KEY)
    assert eager_eng.stats()["stash_fetches"] > 1
    assert_same(got, want)
    assert_same(got, eager)


class TestUniTokOwnerKernel:
    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_owner_equals_xla(self, lm, quant):
        """The owner mode (region recycling under displacing admission)
        gives the plain attention's codes on the same pool format, and on
        the float pool the JAX solo generates'."""
        cfg, jlm, variables, _ = lm

        def reqs():
            rng = np.random.default_rng(3)
            return [UniTokRequest(task_id=i % 7, num_frames=4 + i,
                                  input_feats=rng.standard_normal(
                                      (5, cfg.audio_dim)).astype(np.float32),
                                  do_sample=False, uid=i) for i in range(4)]

        owner = port_engine(lm, num_slots=2, use_kernel="owner",
                            kv_quant=quant)
        a = owner.run(reqs())
        assert owner.stats()["attention"] == "owner"
        assert owner.stats()["prefill_waves"] >= 2
        b = port_engine(lm, num_slots=2, use_kernel="",
                        kv_quant=quant).run(reqs())
        assert_same(a, b)
        if quant:
            return
        for r in reqs():
            np.testing.assert_array_equal(a[r.uid].codes,
                                          _jax_generate(jlm, variables, r))


class TestUniTokOvershoot:
    def test_overshoot_token_exact_with_fewer_dispatches(self, lm):
        """``run`` and overshot ``step(n)`` calls (each to the next
        completion rounded up to a power of two; steps past a slot's end
        are no-ops for it) give the codes of the JAX engine with an
        overshoot of 0.3 (the tiny segments of 8-14 steps need that much
        for a round-up; JAX's default is 0.05), the overshot drive in
        fewer step calls."""
        cfg = lm[0]
        rng = np.random.default_rng(5)
        lengths = [10, 14, 10, 12, 10, 14]
        feats = [rng.standard_normal((5, cfg.audio_dim)).astype(np.float32)
                 for _ in lengths]

        def reqs(cls):
            return [cls(task_id=i % 7, num_frames=nf, input_feats=feats[i],
                        do_sample=False, uid=900 + i)
                    for i, nf in enumerate(lengths)]

        want = jax_engine(lm, num_slots=2, dispatch_overshoot=0.3).run(
            reqs(j_unitok.UniTokRequest), KEY, poll_interval=8)
        exact = port_engine(lm, num_slots=2)
        a = exact.run(reqs(UniTokRequest), poll_interval=8)
        assert exact.stats()["poll_interval"] == 8
        over = port_engine(lm, num_slots=2)
        pending, b, calls = reqs(UniTokRequest), {}, 0
        while pending or any(u is not None for u in over._uids):
            b.update({r.uid: r for r in over.harvest()})
            while pending and over.free_slots():
                sig = over._signature(pending[0])
                got = set(over.admit_wave([r for r in pending
                                           if over._signature(r) == sig]))
                pending = [r for r in pending if r.uid not in got]
            live = [n for n in over._remaining if n > 0]
            if live:
                over.step(1 << (min(live) - 1).bit_length())
                calls += 1
        assert_same(a, want)
        assert_same(b, want)
        assert calls < exact.stats()["step_dispatches"]


def test_one_device_read_per_harvest(lm, monkeypatch):
    """``harvest`` and ``drain_stashes`` read the device once each
    (``Tensor.cpu`` counted)."""
    calls = []
    inner = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return inner(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    eng = port_engine(lm)
    k, width = eng.K, eng.max_steps * eng.K + 1
    out = eng.run(displacing_requests(UniTokRequest, lm[0]))
    assert len(out) == 9
    assert calls == [(5, width), (4, width)]  # the drain, then the harvest
    calls.clear()
    reqs = displacing_requests(UniTokRequest, lm[0])[:2]
    assert eng.admit_wave(reqs) == [700, 701]
    eng.step(n=max(r.num_frames for r in reqs) + k - 1)
    assert len(eng.harvest()) == 2 and calls == [(4, width)]


def test_run_admits_every_signature_while_slots_last(lm):
    """Requests of two signatures (input only; reference and input) fill
    the 4 slots in the first round, one wave each, and decode together;
    the codes are the JAX engine's, which admits one signature a round."""
    cfg = lm[0]
    rng = np.random.default_rng(11)

    def feats(n):
        return rng.standard_normal((n, cfg.audio_dim)).astype(np.float32)

    spec = [(feats(5), None), (feats(6), feats(4)), (feats(4), None),
            (feats(7), feats(3))]

    def reqs(cls):
        return [cls(task_id=i % 6, num_frames=6, input_feats=x, ref_feats=r,
                    do_sample=False, uid=40 + i)
                for i, (x, r) in enumerate(spec)]

    eng = port_engine(lm)
    got = eng.run(reqs(UniTokRequest))
    st = eng.stats()
    assert st["prefill_waves"] == 2
    assert st["decode_steps"] == 6 + eng.K - 1  # one round for all four
    j_eng = jax_engine(lm)
    assert_same(got, j_eng.run(reqs(j_unitok.UniTokRequest), KEY))
    assert j_eng.stats()["step_dispatches"] > st["step_dispatches"]
