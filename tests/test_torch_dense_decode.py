"""The dense one-token decode with a position per sequence
(``LlamaBackbone.decode_step_multi`` / ``CodecLM.decode_ids_multi``)
against the JAX package's, and the port's paged decode against it.

Slots sit at staggered depths: a prompt is prefilled for every slot and
each slot's index is then set to its own depth (the positions past it are
masked and overwritten). Tolerances: logits within atol/rtol 1e-4 against
JAX, greedy ids equal; the paged decode within 2e-4 of the dense one, the
bound of the JAX package's own paged-against-dense test
(tests/test_engine.py test_paged_decode_matches_dense).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TOL, jax_sft, port_config, port_sft
from unified_audio_tpu.models.lm.llama import LlamaConfig, init_cache
from unified_audio_tpu_torch.models.lm import llama as t_llama
from unified_audio_tpu_torch.serve import paged as t_paged

DEPTHS = (3, 11, 6, 0)  # each slot's index after the prefill
PROMPT, MAX_LEN, STEPS = 12, 24, 6


@pytest.fixture(scope="module")
def lm():
    cfg = LlamaConfig(global_size=16, semantic_size=32, hidden_size=32,
                      num_layers=2, num_heads=4)
    sft, variables = jax_sft(cfg, feats_dim=8)
    return cfg, sft, variables, port_sft(cfg, variables, feats_dim=8)


def _prompt(cfg):
    return np.random.default_rng(3).standard_normal(
        (len(DEPTHS), PROMPT, cfg.hidden_size)).astype(np.float32)


def _ids0(cfg):
    return np.random.default_rng(4).integers(
        0, cfg.vocab_size, len(DEPTHS)).astype(np.int32)


def port_dense(lm, steps=STEPS):
    """The port's prefill, the slots set to DEPTHS, then ``steps`` greedy
    ``decode_ids_multi`` steps -> (logits per step, ids per step, cache)."""
    cfg, tlm = port_config(lm[0]), lm[3]
    cache = t_llama.init_cache(cfg, len(DEPTHS), MAX_LEN)
    with torch.no_grad():
        tlm.cached_forward(torch.as_tensor(_prompt(lm[0])), cache)
        cache["index"] = torch.tensor(DEPTHS, dtype=torch.int32)
        ids = torch.as_tensor(_ids0(lm[0]))
        logits, out = [], []
        for _ in range(steps):
            step, cache = tlm.decode_ids_multi(ids, cache)
            ids = torch.argmax(step, -1).int()
            logits.append(step.numpy())
            out.append(ids.numpy())
    return logits, out, cache


def test_decode_ids_multi_matches_jax(lm):
    cfg, sft, variables, _ = lm
    cache = init_cache(cfg, len(DEPTHS), MAX_LEN)
    _, cache = sft.apply(variables, jnp.asarray(_prompt(cfg)), cache,
                         method=lambda m, p, c: m.lm.backbone.prefill(p, c))
    cache["index"] = jnp.asarray(DEPTHS, jnp.int32)
    ids = jnp.asarray(_ids0(cfg))
    got_logits, got_ids, t_cache = port_dense(lm)
    for i in range(STEPS):
        logits, cache = sft.apply(
            variables, ids, cache,
            method=lambda m, x, c: m.lm.decode_ids_multi(x, c))
        ids = jnp.argmax(logits, -1).astype(jnp.int32)
        np.testing.assert_allclose(got_logits[i], np.asarray(logits), **TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(got_ids[i], np.asarray(ids))
    np.testing.assert_array_equal(t_cache["index"].numpy(),
                                  np.asarray(cache["index"]))
    for name in ("k", "v"):
        for b, d in enumerate(DEPTHS):  # the positions each slot has seen
            np.testing.assert_allclose(
                t_cache[name][:, b, :d + STEPS].numpy(),
                np.asarray(cache[name])[:, b, :d + STEPS], **TOL)


def test_scalar_index_matches_multi_at_equal_depths(lm):
    """With every slot at one depth the per-slot path is the scalar one."""
    cfg, tlm = port_config(lm[0]), lm[3]
    prompt = torch.as_tensor(_prompt(lm[0]))
    ids = torch.as_tensor(_ids0(lm[0]))
    out = []
    for multi in (False, True):
        cache = t_llama.init_cache(cfg, len(DEPTHS), MAX_LEN)
        with torch.no_grad():
            tlm.cached_forward(prompt, cache)
            if multi:
                cache["index"] = torch.full((len(DEPTHS),), PROMPT,
                                            dtype=torch.int32)
                logits, cache = tlm.decode_ids_multi(ids, cache)
            else:
                logits, cache = tlm.decode_ids(ids, cache)
        out.append((logits, cache))
    (a, ca), (b, cb) = out
    torch.testing.assert_close(a, b, **TOL)
    assert ca["index"] == PROMPT + 1
    assert cb["index"].tolist() == [PROMPT + 1] * len(DEPTHS)
    torch.testing.assert_close(ca["k"], cb["k"], **TOL)


def test_no_host_read(lm, monkeypatch):
    """The per-slot step reads no device value on the host."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read on the host")

    for name in ("item", "tolist", "__int__", "__index__", "__bool__",
                 "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    cfg, tlm = port_config(lm[0]), lm[3]
    cache = t_llama.init_cache(cfg, len(DEPTHS), MAX_LEN)
    cache["index"] = torch.tensor(DEPTHS, dtype=torch.int32)
    with torch.no_grad():
        logits, cache = tlm.decode_ids_multi(
            torch.tensor([1, 2, 3, 4], dtype=torch.int32), cache)
    monkeypatch.undo()
    assert logits.shape == (len(DEPTHS), cfg.vocab_size)


def test_index_at_max_len_raises(lm):
    """A write at max_len is out of range: the port raises (the JAX
    package's scatter drops it)."""
    cfg, tlm = port_config(lm[0]), lm[3]
    cache = t_llama.init_cache(cfg, 2, MAX_LEN)
    cache["index"] = torch.tensor([3, MAX_LEN], dtype=torch.int32)
    with torch.no_grad(), pytest.raises(IndexError):
        tlm.decode_ids_multi(torch.tensor([1, 2]), cache)


BS, REGION = 8, 4  # 4 blocks of 8 hold the deepest slot, 11 + STEPS


@pytest.mark.parametrize("mode", ["", "owner", "stream"])
def test_paged_decode_matches_dense(lm, mode):
    """The port's paged decode (plain attention, and the K1 and K3 plain
    versions) over the same prefilled positions, slot by slot at its own
    depth, gives the dense per-slot decode's logits within 2e-4 and its
    greedy ids."""
    cfg, tlm = port_config(lm[0]), lm[3]
    want_logits, want_ids, _ = port_dense(lm)
    n = len(DEPTHS)
    dense = t_llama.init_cache(cfg, n, PROMPT)
    with torch.no_grad():
        tlm.cached_forward(torch.as_tensor(_prompt(lm[0])), dense)
    alloc = (t_paged.RegionAllocator(REGION * (n + 2), REGION)
             if mode == "owner" else t_paged.BlockAllocator(1 + REGION * n))
    tables = torch.tensor([alloc.alloc(REGION) for _ in range(n)],
                          dtype=torch.int32)
    pool = t_paged.init_pool(cfg, alloc.num_blocks, BS)
    t_paged.scatter_prefill(pool, tables, dense["k"], dense["v"], BS)
    index = torch.tensor(DEPTHS, dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    ids = torch.as_tensor(_ids0(lm[0]))
    with torch.no_grad():
        for i in range(STEPS):
            logits = t_paged.paged_decode_ids(cfg, tlm, pool, tables, index,
                                              active, ids, BS,
                                              use_kernel=mode)
            np.testing.assert_allclose(logits.numpy(), want_logits[i],
                                       atol=2e-4, rtol=0,
                                       err_msg=f"step {i}")
            ids = torch.argmax(logits, -1).int()
            np.testing.assert_array_equal(ids.numpy(), want_ids[i])
            index = index + 1
