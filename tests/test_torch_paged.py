"""Paged KV pool, port vs JAX: quantize_kv, the allocators, scatter_prefill
and multi-step greedy decode trajectories through paged_decode_ids.

The port's decode step runs in the plain mode (""), the owner mode (the
K1/K2 plain versions on the CPU) and the stream mode (the K3/K4 plain
versions); the JAX side runs its plain path.
The float pool is fp32 here (bf16 on the card). Tolerances: floats within
atol/rtol 1e-4; greedy tokens exact; int8 pool values exact except at most
1 LSB where the float inputs sit at a rounding tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TOL, jax_sft, port_config, port_sft
from unified_audio_tpu.models.lm.llama import LlamaConfig, init_cache
from unified_audio_tpu.serve import paged as j_paged
from unified_audio_tpu_torch.serve import paged as t_paged

BS, NB = 8, 40


@pytest.fixture(scope="module")
def lm():
    cfg = LlamaConfig(global_size=16, semantic_size=32, hidden_size=32,
                      num_layers=2, num_heads=4)
    sft, variables = jax_sft(cfg, feats_dim=8)
    return cfg, sft, variables, port_sft(cfg, variables, feats_dim=8)


def _prefilled(lm, quant):
    """A pool with three slots' 10-token prompts prefilled by JAX into
    region-allocated tables (3, 2 and 3 blocks)."""
    cfg, sft, variables, _ = lm
    alloc = j_paged.RegionAllocator(NB, 4)
    tables = np.zeros((3, 3), np.int32)
    for s, n in enumerate((3, 2, 3)):
        tables[s, :n] = alloc.alloc(n)
    prompt = np.random.default_rng(0).standard_normal(
        (3, 10, cfg.hidden_size)).astype(np.float32)
    cache = init_cache(cfg, 3, 10)
    _, cache = sft.apply(variables, jnp.asarray(prompt), cache,
                         method=lambda m, p, c: m.lm.prefill(p, c))
    pool = j_paged.init_pool(cfg, NB, BS, quant=quant)
    pool = j_paged.scatter_prefill(pool, jnp.asarray(tables), cache["k"],
                                   cache["v"], BS)
    return tables, cache, jax.device_get(pool)


def _assert_pools_close(t_pool, j_pool):
    """Pools agree outside the trash block (block 0), whose rows hold the
    inactive slots' discarded writes."""
    for name, want in j_pool.items():
        got, want = t_pool[name].numpy()[:, 1:], want[:, 1:]
        if want.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=name)


class TestPool:
    def test_quantize_kv_bit_exact(self):
        x = np.random.default_rng(1).standard_normal((6, 64)).astype(
            np.float32)
        x[0, :3] = [127.0, 0.5, -0.5]  # an exact row with ties
        jq, js = j_paged.quantize_kv(jnp.asarray(x))
        tq, ts = t_paged.quantize_kv(torch.as_tensor(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_init_pool(self, lm, quant):
        cfg = lm[0]
        j = j_paged.init_pool(cfg, NB, BS, quant=quant)
        t = t_paged.init_pool(port_config(cfg), NB, BS, quant=quant)
        assert sorted(t) == sorted(j)
        for k in j:
            assert tuple(t[k].shape) == j[k].shape
            assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype)

    @pytest.mark.parametrize("make", [lambda m: m.BlockAllocator(64),
                                      lambda m: m.RegionAllocator(128, 14)])
    def test_allocators_match(self, make):
        """Same alloc/release sequence, same blocks and budgets."""
        j, t = make(j_paged), make(t_paged)
        held_j, held_t = [], []
        for n in (3, 5, 2, 9, 1):
            assert t.block_cost(n) == j.block_cost(n)
            held_j.append(j.alloc(n))
            held_t.append(t.alloc(n))
            assert held_t[-1] == held_j[-1]
        for i in (1, 3):
            j.release(held_j[i])
            t.release(held_t[i])
        assert t.alloc(4) == j.alloc(4)
        assert len(t.free) == len(j.free)
        if isinstance(t, t_paged.BlockAllocator):
            assert t.high_water() == j.high_water()
            assert t.bounded_high_water() == j.bounded_high_water()

    def test_region_allocator_validates(self):
        ra = t_paged.RegionAllocator(64, 14)
        with pytest.raises(ValueError):
            ra.alloc(15)
        with pytest.raises(ValueError):
            t_paged.RegionAllocator(20, 14)
        blocks = ra.alloc(3)
        with pytest.raises(ValueError):
            ra.release([blocks[0] + 20])

    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_scatter_prefill(self, lm, quant):
        cfg = lm[0]
        tables, cache, want = _prefilled(lm, quant)
        pool = t_paged.init_pool(port_config(cfg), NB, BS, quant=quant)
        t_paged.scatter_prefill(pool, torch.as_tensor(tables),
                                torch.as_tensor(np.array(cache["k"])),
                                torch.as_tensor(np.array(cache["v"])), BS)
        for name in want:  # same inputs: bit-exact, int8 included
            np.testing.assert_array_equal(pool[name].numpy(), want[name])


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("mode", ["", "owner", "stream"])
def test_greedy_trajectory(lm, quant, mode):
    """Six greedy steps, an inactive slot included: active rows' tokens
    equal JAX's plain path, first-step logits and the final pool close."""
    cfg, _, variables, tsft = lm
    tables, _, pool0 = _prefilled(lm, quant)
    lm_params = variables["params"]["lm"]
    active = np.array([True, False, True])
    j_pool = {k: jnp.asarray(v) for k, v in pool0.items()}
    t_pool = {k: torch.as_tensor(v.copy()) for k, v in pool0.items()}
    idx = np.array([10, 7, 10], np.int32)
    ids = np.array([3, 4, 5], np.int32)
    j_ids, t_ids = ids, torch.as_tensor(ids)
    tcfg = port_config(cfg)
    for step in range(6):
        jl, j_pool = j_paged.paged_decode_ids(
            cfg, lm_params, j_pool, jnp.asarray(tables), jnp.asarray(idx),
            jnp.asarray(active), jnp.asarray(j_ids), BS)
        with torch.no_grad():
            tl = t_paged.paged_decode_ids(
                tcfg, tsft, t_pool, torch.as_tensor(tables),
                torch.as_tensor(idx), torch.as_tensor(active), t_ids, BS,
                use_kernel=mode)
        if step == 0:
            np.testing.assert_allclose(tl.numpy()[active],
                                       np.asarray(jl)[active], **TOL)
        j_ids = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        t_ids = tl.argmax(-1).int()
        np.testing.assert_array_equal(t_ids.numpy()[active], j_ids[active])
        idx = idx + 1
    _assert_pools_close(t_pool, jax.device_get(j_pool))


def test_unknown_mode_raises(lm):
    cfg, _, _, tsft = lm
    pool = t_paged.init_pool(port_config(cfg), NB, BS)
    with pytest.raises(ValueError):
        t_paged.paged_decode_ids(
            port_config(cfg), tsft, pool, torch.zeros((1, 3), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool),
            torch.zeros(1, dtype=torch.int32), BS, use_kernel="bogus")
