"""Port vs JAX: RoPE/RMSNorm, the Llama LM (prefill logits), the SFT prompt
and greedy two-phase generate, and the top-k/top-p filters.

Tolerance: floats atol/rtol 1e-4 (different reduction order); greedy token
ids exact. Sampled tokens are not compared (the RNG streams differ); the
top-k/top-p kept sets are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (TOL, jax_sft, port_config, port_sft,
                               tiny_lm_config)
from unified_audio_tpu.models.lm import llama as j_llama
from unified_audio_tpu.nn import transformer as j_tr
from unified_audio_tpu_torch.models.lm import llama as t_llama
from unified_audio_tpu_torch.nn import transformer as t_tr


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config()
    sft, variables = jax_sft(cfg, feats_dim=12)
    return cfg, sft, variables, port_sft(cfg, variables, feats_dim=12)


class TestPrimitives:
    def test_rope_and_rmsnorm(self):
        rng = np.random.default_rng(0)
        q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
        k = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
        pos = np.arange(3, 8)
        jc, js = j_tr.rope_cos_sin(jnp.asarray(pos), 8)
        tc, ts = t_tr.rope_cos_sin(torch.as_tensor(pos), 8)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        jq, jk = j_tr.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
        tq, tk = t_tr.apply_rope(torch.as_tensor(q), torch.as_tensor(k),
                                 tc, ts)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        w = rng.standard_normal(8).astype(np.float32)
        jy = j_tr.RMSNorm(8).apply({"params": {"weight": jnp.asarray(w)}},
                                   jnp.asarray(q))
        ty = t_tr.rms_norm(torch.as_tensor(q), torch.as_tensor(w))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)

    def test_rope_keeps_bf16(self):
        """The rotation runs in fp32 but q/k stay bf16."""
        q = torch.randn(1, 3, 2, 8, dtype=torch.bfloat16)
        cos, sin = t_tr.rope_cos_sin(torch.arange(3), 8)
        tq, tk = t_tr.apply_rope(q, q, cos, sin)
        assert tq.dtype == tk.dtype == torch.bfloat16

    def test_range_mask(self):
        cfg = tiny_lm_config()
        j = j_llama.range_mask(cfg, cfg.global_offset, cfg.global_size)
        t = t_llama.range_mask(port_config(cfg), cfg.global_offset,
                               cfg.global_size)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


class TestLM:
    def test_prefill_logits(self, lm):
        cfg, sft, variables, tsft = lm
        rng = np.random.default_rng(1)
        prompt = rng.standard_normal((2, 9, cfg.hidden_size)).astype(
            np.float32)
        cache = j_llama.init_cache(cfg, 2, 12)
        jl, jc = sft.apply(variables, jnp.asarray(prompt), cache,
                           method=lambda m, p, c: m.lm.prefill(p, c))
        tc = t_llama.init_cache(tsft.cfg, 2, 12)
        with torch.no_grad():
            tl, tc = tsft.prefill(torch.as_tensor(prompt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   **TOL)
        assert tc["index"] == int(jc["index"]) == 9

    def test_prompt(self, lm):
        cfg, sft, variables, tsft = lm
        rng = np.random.default_rng(2)
        mix = rng.standard_normal((2, 7, 12)).astype(np.float32)
        enr = rng.standard_normal((2, 5, 12)).astype(np.float32)
        jp = sft.apply(variables, jnp.asarray([1, 2]), jnp.asarray(enr),
                       jnp.asarray(mix), method="_prompt")
        with torch.no_grad():
            tp = tsft.prompt(torch.tensor([1, 2]), torch.as_tensor(enr),
                             torch.as_tensor(mix))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)

    @pytest.mark.parametrize("with_enroll", [False, True])
    def test_greedy_generate_tokens(self, lm, with_enroll):
        """Two-phase greedy generate, the discarded 33rd-style global step
        included, gives the same token ids."""
        cfg, sft, variables, tsft = lm
        rng = np.random.default_rng(3)
        mix = rng.standard_normal((2, 10, 12)).astype(np.float32)
        enr = (rng.standard_normal((2, 6, 12)).astype(np.float32)
               if with_enroll else None)
        jg, js = sft.apply(
            variables, 1, None if enr is None else jnp.asarray(enr),
            jnp.asarray(mix), jax.random.PRNGKey(0), method="generate",
            global_length=4, semantic_length=7, do_sample=False)
        tg, ts = tsft.generate(
            1, None if enr is None else torch.as_tensor(enr),
            torch.as_tensor(mix), None, global_length=4, semantic_length=7,
            do_sample=False)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def test_sampled_generate_in_range(self, lm):
        cfg, _, _, tsft = lm
        mix = torch.randn(2, 10, 12, generator=torch.Generator().manual_seed(0))
        g, s = tsft.generate(0, None, mix, torch.Generator().manual_seed(1),
                             global_length=4, semantic_length=5, top_k=5)
        assert g.shape == (2, 4) and s.shape == (2, 5)
        assert 0 <= int(g.min()) and int(g.max()) < cfg.global_size
        assert 0 <= int(s.min()) and int(s.max()) < cfg.semantic_size


def _jax_kept(logits, top_k, top_p, monkeypatch):
    """The logits JAX's sample_logits hands to its categorical draw."""
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    j_llama.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits),
                          temperature=1.0, top_k=top_k, top_p=top_p)
    monkeypatch.undo()
    return seen["logits"] > j_llama.NEG_INF / 2


class TestSampling:
    @pytest.mark.parametrize("top_k,top_p", [(50, 0.95), (5, 0.5), (3, 1.0),
                                             (0, 0.9), (1, 0.95)])
    def test_filter_kept_set(self, top_k, top_p, monkeypatch):
        """Top-k then top-p (first crossing token kept): same kept set."""
        rng = np.random.default_rng(4)
        logits = (2 * rng.standard_normal((4, 64))).astype(np.float32)
        want = _jax_kept(logits, top_k, top_p, monkeypatch)
        got = t_llama.filter_logits(torch.as_tensor(logits), top_k, top_p)
        np.testing.assert_array_equal(got.numpy() > t_llama.NEG_INF / 2, want)

    def test_vec_filter_matches_per_row(self, monkeypatch):
        """Per-row parameters: each row's kept set equals JAX's scalar
        filter with that row's top_k/top_p."""
        rng = np.random.default_rng(5)
        logits = (2 * rng.standard_normal((4, 64))).astype(np.float32)
        ks, ps = [50, 5, 1, 20], [0.95, 0.5, 0.9, 1.0]
        got = t_llama.filter_logits_vec(
            torch.as_tensor(logits), torch.tensor(ks), torch.tensor(ps),
            max_top_k=32)
        for i in range(4):
            want = _jax_kept(logits[i:i + 1], min(ks[i], 32), ps[i],
                             monkeypatch)
            np.testing.assert_array_equal(
                got[i:i + 1].numpy() > t_llama.NEG_INF / 2, want)

    def test_vec_greedy_rows_take_argmax(self):
        logits = torch.randn(3, 40, generator=torch.Generator().manual_seed(0))
        out = t_llama.sample_logits_vec(
            torch.Generator().manual_seed(1), logits,
            torch.ones(3), torch.full((3,), 5), torch.full((3,), 0.9),
            torch.tensor([False, True, False]))
        arg = logits.argmax(-1)
        assert out[0] == arg[0] and out[2] == arg[2]
        kept = t_llama.filter_logits_vec(logits, torch.full((3,), 5),
                                         torch.full((3,), 0.9))
        assert kept[1, out[1]] > t_llama.NEG_INF / 2
