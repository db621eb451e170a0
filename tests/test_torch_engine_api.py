"""The port's UniSE serving engine API against the JAX package's
``ContinuousBatchingEngine``: the input wires, cancel, displacing admission
with stashed outputs, ``step(n)``, ``prestage`` and ``stage_request``, and
the counters of ``stats()``.

Mirrors, by name, tests of tests/test_engine.py and
tests/test_engine_overshoot.py (the JAX engine's own, in the slow tier) on
the same tiny LM (2 layers, hidden 32, 12-dim features), fp32. Greedy
tokens must equal the JAX engine's exactly; the JAX engines run once per
configuration in module fixtures. Sampled tokens cannot match JAX's PRNG,
so sampled runs are held to the port's own runs (owner against plain
attention, ``run`` against overshot ``step(n)`` calls).

The port has one schedule where the JAX engine has options (eager drain,
dispatch overshoot, ``unify_waves=False``, separate enroll buckets, other
waveform wires): greedy tokens do not depend on the schedule, so the
port's are held to the JAX engine's under each of those options.

The wire fault: JAX ``serve`` sends the peak-normalized mix as int16
samples (a positive peak of 1.0 becomes 32767/32768); before the port had
the wire its features came from the unrounded waveform. On the tiny UniSE
stack below that put the port's mix features up to 2.7e-4 from JAX's (the
greedy tokens still agreed on these inputs); with the int16 wire they agree
within 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (jax_sft, port_sft, port_unise, tiny_lm_config,
                               tiny_unise_jax)
from unified_audio_tpu.serve import engine as j_engine
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.serve import engine as t_engine
from unified_audio_tpu_torch.serve.engine import (ContinuousBatchingEngine,
                                                  Request)

FD = 12
KEY = jax.random.PRNGKey(0)
# (global, semantic) lengths: completions interleave mid-wave
STAGGERED = [(2, 3), (4, 9), (1, 6), (3, 12), (2, 5), (4, 4)]
# popcount-heavy semantic lengths (max_semantic 64) for the overshoot
OVERSHOOT = [(4, 55), (3, 59), (4, 45), (2, 61), (4, 53), (3, 47)]
ENGINE_KW = dict(num_slots=2, block_size=8, max_global=8, max_semantic=16,
                 mix_buckets=(10, 16))


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config()
    sft, variables = jax_sft(cfg, feats_dim=FD)
    return sft, variables, port_sft(cfg, variables, feats_dim=FD)


def jax_engine(lm, **kw):
    return j_engine.ContinuousBatchingEngine(lm[0], lm[1],
                                             **{**ENGINE_KW, **kw})


def port_engine(lm, **kw):
    return ContinuousBatchingEngine(lm[2], **{**ENGINE_KW, **kw})


def _feats(seed, n=10):
    return np.random.default_rng(seed).standard_normal(
        (n, FD)).astype(np.float32)


def requests(cls, lengths, base, feats=_feats):
    """Mixed tasks: every third request is SE, the others enroll on their
    own mix features."""
    return [cls(task_id=i % 3, mix_feats=feats(base + i),
                enroll_feats=feats(base + i) if i % 3 else None,
                global_length=g, semantic_length=s, do_sample=False,
                uid=base + i)
            for i, (g, s) in enumerate(lengths)]


def assert_same(got, want):
    assert set(got) == set(want)
    for uid in want:
        np.testing.assert_array_equal(np.asarray(got[uid].global_ids),
                                      np.asarray(want[uid].global_ids),
                                      err_msg=f"uid {uid} global")
        np.testing.assert_array_equal(np.asarray(got[uid].semantic_ids),
                                      np.asarray(want[uid].semantic_ids),
                                      err_msg=f"uid {uid} semantic")


@pytest.fixture(scope="module")
def jax_staggered(lm):
    return jax_engine(lm).run(requests(j_engine.Request, STAGGERED, 100), KEY)


@pytest.fixture(scope="module")
def jax_overshoot(lm):
    eng = jax_engine(lm, max_semantic=64, mix_buckets=(10,))
    return eng.run(requests(j_engine.Request, OVERSHOOT, 700), KEY)


def test_staggered_lengths_match_solo_runs(lm, jax_staggered):
    """Displacing admission over interleaved completions gives each request
    its solo run's tokens, and the JAX engine's."""
    reqs = requests(Request, STAGGERED, 100)
    solo = {}
    for r in reqs:
        solo.update(port_engine(lm).run([r]))
    mixed = port_engine(lm).run(requests(Request, STAGGERED, 100))
    assert_same(mixed, solo)
    assert_same(mixed, jax_staggered)


def test_deferred_drain_matches_eager(lm, jax_staggered):
    """The port drains every stash in one read at the end; its tokens are
    the JAX engine's with the deferred drain and with the eager one (a
    fetch after each wave's first chunk)."""
    deferred_eng = port_engine(lm)
    deferred = deferred_eng.run(requests(Request, STAGGERED, 100))
    assert deferred_eng.stats()["stash_fetches"] == 1
    eager_eng = jax_engine(lm, eager_drain=True)
    eager = eager_eng.run(requests(j_engine.Request, STAGGERED, 100), KEY)
    assert eager_eng.stats()["stash_fetches"] > 1
    assert_same(deferred, eager)
    assert_same(deferred, jax_staggered)


def test_stats_counters(lm):
    """The counters agree with the request stream and with the JAX engine
    run the same way (exact decomposition), and the pool is released."""
    reqs = [dict(task_id=0, mix_feats=_feats(300 + i), global_length=2,
                 semantic_length=4, do_sample=False, uid=i)
            for i in range(5)]
    eng = port_engine(lm)
    got = eng.run([Request(**r) for r in reqs])
    j_eng = jax_engine(lm, dispatch_overshoot=0.0)
    want = j_eng.run([j_engine.Request(**r) for r in reqs], KEY)
    assert_same(got, want)
    st, jst = eng.stats(), j_eng.stats()
    for k in ("requests_admitted", "requests_completed", "tokens_generated",
              "decode_steps", "step_dispatches", "prefill_waves",
              "stash_fetches", "poll_interval", "last_nb", "blocks_held",
              "active_slots"):
        assert st[k] == jst[k], k
    assert st["requests_completed"] == 5
    assert st["tokens_generated"] == 5 * (2 + 1 + 4)
    assert st["requests_cancelled"] == 0
    assert st["blocks_held"] == 0 and st["active_slots"] == 0
    for k in ("t_prestage", "t_admit", "t_step", "t_drain", "t_harvest"):
        assert st[k] >= 0.0
    assert st["t_step"] > 0.0


def test_cancel_mid_flight(lm, jax_staggered):
    """Cancelling one request frees its slot and blocks at once and leaves
    the survivor's greedy tokens as its solo run's (JAX's); every block
    comes back."""
    keep = requests(Request, STAGGERED, 100)[3]  # SE, 3 + 12 tokens
    eng = port_engine(lm)
    free0 = len(eng.allocator.free)
    victim = Request(task_id=0, mix_feats=_feats(9), global_length=8,
                     semantic_length=16, do_sample=False, uid=2)
    assert eng.admit_many([keep, victim]) == [keep.uid, 2]
    eng.step(n=4)
    assert eng.cancel(2)
    assert not eng.cancel(99)
    assert int(eng.state["phase"][1]) == t_engine.PHASE_DONE
    assert eng.free_slots() == [1]
    res = None
    for _ in range(40):
        eng.step(n=4)
        out = eng.harvest()
        if out:
            res = out[0]
            break
    assert res is not None and res.uid == keep.uid
    assert_same({res.uid: res}, {keep.uid: jax_staggered[keep.uid]})
    assert len(eng.allocator.free) == free0
    assert eng.stats()["requests_cancelled"] == 1


def test_owner_sampled_run_displaces_regions(lm):
    """Sampled traffic through the owner mode (region recycling under
    displacing admission) draws the plain attention's tokens from the same
    generator."""
    def run(mode):
        eng = port_engine(lm, use_kernel=mode)
        reqs = [Request(task_id=0, mix_feats=_feats(i), global_length=3,
                        semantic_length=5, do_sample=True, temperature=0.9,
                        top_k=8, uid=i) for i in range(6)]
        out = eng.run(reqs, torch.Generator().manual_seed(7))
        assert eng.stats()["prefill_waves"] == 3
        return out

    assert_same(run("owner"), run(""))


class TestInt8FeatureWire:
    def test_quantize_dequant_error_bound(self):
        """The port's int8 rows are JAX's bit for bit; its dequant is q *
        2^e exactly (JAX's exp2 is exact only for |e| <= 12 on the CPU, so
        its values are held within 1e-5 relative)."""
        rng = np.random.default_rng(3)
        x = (rng.standard_normal((20, FD)).astype(np.float32)
             * rng.uniform(1e-3, 1e3, (20, 1)).astype(np.float32))
        wire = t_engine._quantize_feats_row(x)
        np.testing.assert_array_equal(wire, j_engine._quantize_feats_row(x))
        assert wire.dtype == np.int8 and wire.shape == (20, FD + 1)
        back = t_engine._dequant_feats(torch.as_tensor(wire)[None],
                                       torch.float32)[0].numpy()
        exact = wire[:, :-1].astype(np.float32) * np.ldexp(
            np.float32(1), wire[:, -1:].astype(np.int32))
        np.testing.assert_array_equal(back, exact)
        np.testing.assert_allclose(
            back, np.asarray(j_engine._dequant_feats(wire[None],
                                                     jnp.float32))[0],
            rtol=1e-5, atol=0)
        bound = np.abs(x).max(axis=-1, keepdims=True) / 126.0
        assert (np.abs(back - x) <= bound + 1e-12).all()
        z = t_engine._quantize_feats_row(np.zeros((4, FD), np.float32))
        assert (t_engine._dequant_feats(torch.as_tensor(z), torch.float32)
                == 0).all()

    def test_int8_wire_exact_for_pow2_features(self, lm):
        """Features of the form q * 2^e cross the int8 wire losslessly: the
        int8 engine's tokens equal the bf16 wire's and JAX's int8 engine's,
        enroll rows and displacing waves included; the staged rows are
        JAX's."""
        rng = np.random.default_rng(4)
        feats = []
        for _ in range(5):
            q = rng.integers(-127, 128, (10, FD)).astype(np.float32)
            q[0, 0] = 127.0
            feats.append((q * 0.25).astype(np.float32))

        def reqs(cls):
            return [cls(task_id=i % 3, mix_feats=feats[i],
                        enroll_feats=feats[(i + 1) % 5] if i % 3 else None,
                        global_length=3, semantic_length=5 + i,
                        do_sample=False, uid=400 + i) for i in range(5)]

        eng = port_engine(lm, feats_wire="int8")
        eng.prestage(reqs(Request))
        buf, row = eng._staged[400][0]
        np.testing.assert_array_equal(
            buf[row, :10].numpy(), j_engine._quantize_feats_row(feats[0]))
        eng._staged.clear()
        got = eng.run(reqs(Request))
        assert_same(got, port_engine(lm).run(reqs(Request)))
        assert_same(got, jax_engine(lm, feats_wire="int8").run(
            reqs(j_engine.Request), KEY))

    def test_int8_wire_deterministic_and_close(self, lm):
        """Arbitrary features: the int8 wire is lossy but deterministic and
        gives JAX's int8 engine's tokens; an unknown wire is refused."""
        def reqs(cls):
            return [cls(task_id=i % 3, mix_feats=_feats(500 + i),
                        enroll_feats=_feats(500 + i) if i % 3 else None,
                        global_length=4, semantic_length=6, do_sample=False,
                        uid=500 + i) for i in range(4)]

        a = port_engine(lm, feats_wire="int8").run(reqs(Request))
        assert_same(a, port_engine(lm, feats_wire="int8").run(reqs(Request)))
        assert_same(a, jax_engine(lm, feats_wire="int8").run(
            reqs(j_engine.Request), KEY))
        with pytest.raises(ValueError):
            port_engine(lm, feats_wire="fp4")


PROJ = np.random.default_rng(7).standard_normal((4, FD)).astype(np.float32)


def _toy_frontend_jax(fparams, wav):
    b, n = wav.shape
    return jnp.einsum("btk,kd->btd", wav.reshape(b, n // 4, 4),
                      fparams["proj"])


def _toy_frontend(wav):
    b, n = wav.shape
    return torch.einsum("btk,kd->btd", wav.reshape(b, n // 4, 4),
                        torch.as_tensor(PROJ))


def test_wav_int16_wire_matches_quantized_reference(lm):
    """The int16 wire on a peak-normalized waveform: the staged samples are
    the JAX engine's, and the port's tokens equal the JAX engine's and
    JAX's generate over the features of the int16-rounded waveform."""
    sft, variables, _ = lm
    wav = np.random.default_rng(8).standard_normal(40).astype(np.float32)
    wav[5] = 2 * np.abs(wav).max()
    wav /= wav[5]  # a positive peak of 1.0, samples off the int16 grid
    rounded = np.clip(np.rint(wav * 32768), -32768, 32767) / 32768.0
    feats = _toy_frontend_jax({"proj": PROJ}, jnp.asarray(
        rounded, jnp.float32)[None])
    ref_g, ref_s = sft.apply(variables, 1, None, feats, KEY,
                             method="generate", global_length=4,
                             semantic_length=6, do_sample=False)
    j_eng = jax_engine(lm, feature_fn=_toy_frontend_jax,
                       feature_params={"proj": jnp.asarray(PROJ)},
                       wav_buckets=(40, 64), enroll_wav_buckets=(40,))
    want = j_eng.run([j_engine.Request(task_id=1, mix_wav=wav,
                                       global_length=4, semantic_length=6,
                                       do_sample=False, uid=5)], KEY)
    np.testing.assert_array_equal(want[5].global_ids, np.asarray(ref_g[0]))
    np.testing.assert_array_equal(want[5].semantic_ids, np.asarray(ref_s[0]))

    eng = port_engine(lm, feature_fn=_toy_frontend, frames_fn=lambda n: n // 4,
                      wav_buckets=(40, 64))
    assert set((10, 16)) <= set(eng.buckets)
    req = Request(task_id=1, mix_wav=wav, global_length=4, semantic_length=6,
                  do_sample=False, uid=5)
    eng.prestage([req])
    buf, row = eng._staged[5][0]
    assert buf.dtype == torch.int16 and int(buf[row, 5]) == 32767
    np.testing.assert_array_equal(buf[row].numpy(), j_eng._to_wire(wav))
    eng._staged.clear()
    assert_same(eng.run([req]), want)


class TestSegmentChunks:
    """The port's decomposition is JAX's ``segment_chunks`` without the
    overshoot; JAX's 0.05 saves step calls that on the port would each be
    a real step."""

    def test_pow2_within_poll_interval(self):
        for rem in (1, 7, 33, 130, 250, 256, 283, 511, 600):
            for pi in (64, 256):
                ch = t_engine.segment_chunks(rem, pi)
                assert ch == j_engine.segment_chunks(rem, rem, pi, 0.0)
                assert sum(ch) == rem
                assert all(c & (c - 1) == 0 and 1 <= c <= pi for c in ch)
                assert ch == sorted(ch, reverse=True)

    def test_fewer_dispatches_than_popcount(self):
        """JAX's overshoot covers 283 steps in 2 calls where the port, one
        call a set bit, makes 5."""
        assert j_engine.segment_chunks(283, 283, 256, 0.05) == [256, 32]
        assert j_engine.segment_chunks(250, 250, 256, 0.05) == [256]
        assert len(t_engine.segment_chunks(283, 256)) == 5
        assert t_engine.segment_chunks(250, 256) == [128, 64, 32, 16, 8, 2]

    def test_zero_overshoot_restores_exact(self):
        assert t_engine.segment_chunks(283, 256) == [256, 16, 8, 2, 1]
        assert t_engine.segment_chunks(283, 256) == \
            j_engine.segment_chunks(283, 283, 256, 0.0)

    def test_coarse_spends_other_slots_work(self):
        """JAX's coarse mode spends the other slots' live work on a round
        up; the port's chunks of a segment depend on its length alone."""
        assert j_engine.segment_chunks(130, 283, 256, 0.05,
                                       coarse=True) == [256]
        assert t_engine.segment_chunks(130, 256) == [128, 2] == \
            j_engine.segment_chunks(130, 283, 256, 0.05)


def overshot_drive(eng, reqs, generator=None):
    """Admit, then step to the next completion rounded up to a power of
    two (the JAX engine's overshoot, taken by the caller through
    ``step(n)``), harvest, again -> (results, step calls)."""
    pending, out, calls = list(reqs), {}, 0
    while True:
        out.update({r.uid: r for r in eng.harvest()})
        if pending:
            admitted = set(eng.admit_many(pending))
            pending = [r for r in pending if r.uid not in admitted]
        live = [eng._remaining[i] for i in range(eng.num_slots)
                if eng._uids[i] is not None and eng._remaining[i] > 0]
        if not live:
            return out, calls
        eng.step(1 << (min(live) - 1).bit_length(), generator)
        calls += 1


class TestOvershootEndToEnd:
    def test_overshoot_token_exact_with_fewer_dispatches(self, lm,
                                                          jax_overshoot):
        """``run`` and overshot ``step(n)`` calls (steps past a slot's end
        are no-ops for it) give the tokens of the JAX engine with its 0.05
        overshoot; the overshot drive makes fewer step calls."""
        kw = dict(max_semantic=64, mix_buckets=(10,))
        exact_eng = port_engine(lm, **kw)
        exact = exact_eng.run(requests(Request, OVERSHOOT, 700))
        over, calls = overshot_drive(port_engine(lm, **kw),
                                     requests(Request, OVERSHOOT, 700))
        assert_same(exact, jax_overshoot)
        assert_same(over, jax_overshoot)
        assert calls < exact_eng.stats()["step_dispatches"]

    def test_sampled_decode_overshoot_deterministic(self, lm):
        """A sampled request alone draws the same tokens from the same
        generator through ``run`` and through overshot step calls."""
        def req():
            return Request(task_id=0, mix_feats=_feats(11), global_length=4,
                           semantic_length=55, do_sample=True,
                           temperature=1.0, uid=11)

        kw = dict(max_semantic=64, mix_buckets=(10,))
        exact = port_engine(lm, **kw).run([req()],
                                          torch.Generator().manual_seed(3))
        over, _ = overshot_drive(port_engine(lm, **kw), [req()],
                                 torch.Generator().manual_seed(3))
        assert_same(exact, over)


class TestUnifiedWaves:
    def _reqs(self, cls):
        return [cls(task_id=0, mix_feats=_feats(21), global_length=4,
                    semantic_length=6, do_sample=False, uid=1),
                cls(task_id=1, mix_feats=_feats(22, 9),
                    enroll_feats=_feats(23, 6), global_length=3,
                    semantic_length=8, do_sample=False, uid=2)]

    @pytest.mark.parametrize("unify", [True, False])
    def test_se_and_tse_share_one_wave(self, lm, unify):
        """An SE and a TSE request share one wave of a one-bucket port
        engine (the enroll-less one takes the widest enroll bucket); their
        tokens are the JAX engine's with one enroll bucket separate from
        the mix buckets, whether its ``unify_waves`` lets them share a
        wave or (False) gives the SE request its own."""
        eng = port_engine(lm, mix_buckets=(16,))
        reqs = self._reqs(Request)
        assert eng._signature(reqs[0]) == eng._signature(reqs[1])
        got = eng.run(reqs)
        assert eng.stats()["prefill_waves"] == 1
        j_eng = jax_engine(lm, enroll_buckets=(10,), unify_waves=unify)
        want = j_eng.run(self._reqs(j_engine.Request), KEY)
        assert j_eng.stats()["prefill_waves"] == (1 if unify else 2)
        assert_same(got, want)


class TestStaging:
    def test_prestage_matches_unstaged(self, lm, jax_staggered):
        """``prestage`` packs a wave's rows into one buffer per signature
        (mix and enroll); the run admits from them and gives the unstaged
        run's tokens."""
        eng = port_engine(lm)
        reqs = requests(Request, STAGGERED, 100)
        eng.prestage(reqs[1:])  # two enrolled requests of one signature
        assert sorted(eng._staged) == [101, 102]  # the first num_slots
        (m1, e1), (m2, e2) = eng._staged[101], eng._staged[102]
        assert m1[0] is m2[0] and e1[0] is e2[0]  # one buffer each
        assert (m1[1], m2[1], e1[1], e2[1]) == (0, 1, 0, 1)
        assert m1[0].shape == e1[0].shape == (2, 10, FD)
        got = eng.run(reqs)
        assert eng._staged == {}
        assert_same(got, jax_staggered)

    def test_stage_request_device_rows(self, lm):
        """Rows already on the device (a bucket-padded buffer in the engine
        dtype) enter through ``stage_request``; the tokens are the JAX
        engine's staged the same way, and a missing ref falls back to the
        host staging."""
        mix = np.zeros((2, 10, FD), np.float32)
        enr = np.zeros((1, 10, FD), np.float32)
        mix[0, :10], mix[1, :9], enr[0, :7] = _feats(31), _feats(32, 9), \
            _feats(33, 7)

        def reqs(cls):
            return [cls(task_id=1, mix_device_frames=10,
                        enroll_device_frames=7, global_length=3,
                        semantic_length=6, do_sample=False, uid=1),
                    cls(task_id=0, mix_device_frames=9, global_length=2,
                        semantic_length=7, do_sample=False, uid=2),
                    cls(task_id=2, mix_feats=_feats(34),
                        enroll_device_frames=7, global_length=4,
                        semantic_length=5, do_sample=False, uid=3)]

        def run(eng, cls, buf):
            r = reqs(cls)
            m, e = buf(mix), buf(enr)
            eng.stage_request(r[0], (m, 0), (e, 0))
            eng.stage_request(r[1], (m, 1))
            eng.stage_request(r[2], None, (e, 0))
            return eng.run(r, KEY) if cls is j_engine.Request else eng.run(r)

        got = run(port_engine(lm), Request, torch.as_tensor)
        assert_same(got, run(jax_engine(lm), j_engine.Request, jnp.asarray))

    def test_stage_request_stages_a_host_enrollment(self, lm,
                                                    jax_staggered):
        """Without refs, ``stage_request`` stages the mix and a host
        enrollment from the host (JAX's drops the enrollment; ROADMAP
        hazard 25): the tokens are the unstaged run's, which are JAX's. A
        mix on the device with a host enrollment is refused."""
        from dataclasses import replace

        eng = port_engine(lm)
        reqs = requests(Request, STAGGERED, 100)
        eng.stage_request(reqs[1])
        assert eng._staged[101][1] is not None
        assert_same(eng.run(reqs), jax_staggered)
        dev = replace(reqs[2], mix_feats=None, mix_device_frames=10)
        with pytest.raises(ValueError, match="enroll_ref"):
            eng.stage_request(dev, (torch.zeros((1, 10, FD)), 0))

    def test_stage_request_refusals(self, lm):
        eng = port_engine(lm)
        dev = Request(task_id=0, mix_device_frames=10, global_length=2,
                      semantic_length=3, uid=1)
        with pytest.raises(ValueError, match="mix_ref"):
            eng.stage_request(dev)
        with pytest.raises(ValueError, match="never staged"):
            eng.prestage([dev])
        with pytest.raises(ValueError, match="feats_wire"):
            port_engine(lm, feats_wire="int8").validate(dev)
        short = dict(global_length=2, semantic_length=3)
        with pytest.raises(ValueError, match="exactly one"):
            eng.validate(Request(task_id=0, mix_feats=_feats(1),
                                 mix_device_frames=10, uid=2, **short))
        with pytest.raises(ValueError, match="wav_buckets"):
            eng.validate(Request(task_id=0, mix_wav=np.zeros(40, np.float32),
                                 uid=3, **short))


def test_one_device_read_per_harvest(lm, monkeypatch):
    """``harvest`` and ``drain_stashes`` read the device once each
    (``Tensor.cpu`` counted): a run of three waves over two slots makes
    exactly two reads, the end-of-run drain and harvest."""
    calls = []
    inner = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return inner(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    eng = port_engine(lm)
    out = eng.run(requests(Request, STAGGERED[:5], 100))
    assert len(out) == 5 and len(calls) == 2
    assert calls[0] == (3, 8 + 16 + 2)  # three displaced slots
    assert calls[1] == (2, 8 + 16 + 2)  # the whole state
    calls.clear()
    eng.admit_many(requests(Request, STAGGERED[:2], 100))
    eng.step(n=20)
    assert len(eng.harvest()) == 2 and len(calls) == 1


# --- the wire fault, on the tiny UniSE stack (WavLM and the LM) ---

@pytest.fixture(scope="module")
def stacks():
    unise = tiny_unise_jax()
    return unise, port_unise(unise)


def _peak_normalized(rng, n):
    """A mix of ``n`` samples with a positive peak of exactly 1.0 and its
    other samples off the int16 grid."""
    x = (0.2 * rng.standard_normal(n)).astype(np.float32)
    x[rng.integers(n)] = 1.0
    return x


def test_int16_wire_features_and_tokens_match_jax(stacks):
    """A waveform engine as ``serve`` builds it (one segment's sample
    bucket, the int16 wire): the mix features entering the prefill equal
    the JAX engine's within 1e-5 and the greedy tokens are equal; the
    features of the unrounded waveform (the port without the wire) are
    farther from JAX's than that."""
    unise, tunise = stacks
    cfg = unise.config
    seg, sem = cfg.segment_len, unise._semantic_len()
    rng = np.random.default_rng(0)
    wavs = [_peak_normalized(rng, seg) for _ in range(4)]

    def reqs(cls):
        return [cls(task_id=0, mix_wav=w, global_length=cfg.global_tokens,
                    semantic_length=sem, do_sample=False, uid=i)
                for i, w in enumerate(wavs)]

    j_eng = j_engine.ContinuousBatchingEngine(
        unise.sft, unise.sft_params, num_slots=2,
        max_global=cfg.global_tokens, max_semantic=sem + 6,
        mix_buckets=(sem + 6,), feature_fn=unise.wavlm_feats_pure,
        feature_params=unise.wavlm_variables, wav_buckets=(seg,))
    j_feats = []
    frontend = j_eng._frontend_program

    def recording(params, rows):
        out = frontend(params, rows)
        j_feats.append(np.asarray(out)[:2])  # the wave's live rows
        return out

    j_eng._frontend_program = recording
    want = j_eng.run(reqs(j_engine.Request), KEY)

    eng = cli.make_engine(tunise, 2)
    t_feats = []
    fn = eng.feature_fn

    def recording_t(wav):
        out = fn(wav)
        t_feats.append(out.numpy())
        return out

    eng.feature_fn = recording_t
    got = eng.run(reqs(Request))
    assert_same(got, want)
    jf, tf = np.concatenate(j_feats), np.concatenate(t_feats)
    assert tf.shape == jf.shape == (4, sem, cfg.feats_dim)
    assert np.abs(tf - jf).max() <= 1e-5
    unrounded = tunise.wavlm_feats(torch.as_tensor(np.stack(wavs))).numpy()
    assert np.abs(unrounded - jf).max() > 1e-5


def _record_tokens(obj, store):
    inner = obj._decode_tokens

    def wrapped(g, s, orig_len):
        store.append((np.asarray(g), np.asarray(s)))
        return inner(g, s, orig_len)

    obj._decode_tokens = wrapped


def test_cli_serve_matches_jax_serve(stacks, tmp_path, monkeypatch):
    """``serve`` (fp32 LM) and the JAX ``serve`` (its engine built in fp32)
    on off-grid mixes with a one-segment enrollment (the int16 wire) and a
    shorter one (exact-length features): the greedy tokens are equal."""
    from unified_audio_tpu import cli as j_cli

    unise, tunise = stacks
    seg = unise.config.segment_len
    rng = np.random.default_rng(5)
    # 16-bit files: normalizing by the peak puts the samples off the grid
    write_wav(tmp_path / "mix.wav", 0.7 * _peak_normalized(rng, seg + 3000),
              16000)
    write_wav(tmp_path / "e_long.wav", 0.5 * _peak_normalized(rng, seg + 900),
              16000)
    write_wav(tmp_path / "e_short.wav", 0.3 * _peak_normalized(rng, 4000),
              16000)
    lines = [{"task": task, "mix": str(tmp_path / "mix.wav"),
              "enroll": str(tmp_path / enroll),
              "output": str(tmp_path / f"{task}.wav"), "do_sample": False}
             for task, enroll in (("tse", "e_long.wav"),
                                  ("rtse", "e_short.wav"))]
    lines.append({"task": "se", "mix": str(tmp_path / "mix.wav"),
                  "output": str(tmp_path / "se.wav"), "do_sample": False})
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(l) for l in lines))

    got = []
    _record_tokens(tunise, got)
    summary = cli.serve(path, tunise, slots=2, lm_dtype=torch.float32)
    assert summary["segments"] == 6

    class Fp32Engine(j_engine.ContinuousBatchingEngine):
        def __init__(self, *a, dtype=None, **k):
            super().__init__(*a, **k)

    want = []
    _record_tokens(unise, want)
    monkeypatch.setattr(j_engine, "ContinuousBatchingEngine", Fp32Engine)
    monkeypatch.setattr(j_cli, "_build_unise",
                        lambda seed=3407, ckpt=None: unise)
    j_cli.main(["serve", "--requests", str(path), "--slots", "2"])
    assert len(got) == len(want) == 3
    for (tg, ts), (jg, js) in zip(got, want):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(ts, js)


def _admit_reqs(cls, n):
    return [cls(task_id=0, mix_feats=_feats(900 + i), global_length=2,
                semantic_length=3, do_sample=False, uid=900 + i)
            for i in range(n)]


def test_admit_returns_jax_booleans(lm):
    """One request at a time into two slots: admitted while a slot is
    free, refused after, as the JAX engine's ``admit``; the admitted ones
    then run to the JAX engine's tokens."""
    jax_eng, port_eng = jax_engine(lm), port_engine(lm)
    want = [jax_eng.admit(r, KEY) for r in _admit_reqs(j_engine.Request, 3)]
    got = [port_eng.admit(r) for r in _admit_reqs(Request, 3)]
    assert got == want == [True, True, False]
    done = port_eng.run([])
    assert sorted(done) == [900, 901]
    assert_same(done, jax_eng.run([], KEY))


@pytest.mark.parametrize("bad", [
    dict(global_length=99), dict(semantic_length=99),
    dict(temperature=0.0), dict(top_p=0.0), dict(top_k=0),
    dict(mix_feats=np.zeros((99, FD), np.float32))])
def test_admit_validation(lm, bad):
    """The requests the JAX engine's ``admit`` refuses (tests/test_engine.py
    test_admit_validation) raise ValueError in the port's."""
    base = dict(task_id=0, mix_feats=_feats(0), uid=0)
    with pytest.raises(ValueError):
        jax_engine(lm).admit(j_engine.Request(**{**base, **bad}), KEY)
    with pytest.raises(ValueError):
        port_engine(lm).admit(Request(**{**base, **bad}))
