"""Block-table flash decode K7: the port's plain version, through the public
wrapper with CPU tensors, against the JAX package's Pallas kernel
``paged_flash_decode`` (interpret mode, as tests/test_pallas_kernels.py runs
it), and against the port's plain K3 and K1 on the tables their allocators
hand out.

Cases: the JAX test's own (every layer), trash entries past the allocation
holding garbage, a table repeating a physical block, an index past the
table, a slot at position 0 and one on a block boundary, an inactive slot,
the flat pool against its 5-D view, bf16 q and pools. Tolerances: fp32
within atol 2e-5 (the JAX test's own); bf16 within 2 bf16 ulps of JAX's
result on the same bf16 values (``compare_kernels``); the port returns
exact zeros for an inactive slot, where the TPU kernel returns the mean of
V over the table, so only active rows are compared. The CUDA kernel is held
against the plain version on the card in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unified_audio_tpu.ops.pallas import paged_attention as j_pa
from unified_audio_tpu_torch.ops.cuda import paged_attention as t_pa
from unified_audio_tpu_torch.serve import paged as t_paged

L, NB, BS, H, HD = 2, 7, 8, 4, 16
ATOL = 2e-5


def _inputs(seed, n_slots, nb=NB, trash_gain=1.0):
    """q (S, H, hd) and 5-D pools (L, NB, BS, H, hd), fp32, from a seeded
    numpy generator; the trash block (0) scaled by ``trash_gain``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n_slots, H, HD)).astype(np.float32)
    pools = []
    for _ in range(2):
        p = rng.standard_normal((L, nb, BS, H, HD)).astype(np.float32)
        p[:, t_paged.TRASH_BLOCK] *= trash_gain
        pools.append(p)
    return q, *pools


def _jax(q, k, v, tables, index, li):
    return np.asarray(j_pa.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables, jnp.int32), jnp.asarray(index, jnp.int32), li,
        interpret=True))


def _port(q, k, v, tables, index, li):
    return t_pa.paged_flash_decode(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(np.asarray(tables, np.int32)),
        torch.as_tensor(np.asarray(index, np.int32)), li)


CASES = {
    # tests/test_pallas_kernels.py's case
    "jax_test": ([[1, 2, 0], [3, 4, 5], [6, 0, 0]], [11, 20, 3]),
    # logical blocks 0 and 2 of slot 0 (and 0, 1 of slot 1) on one block
    "repeated_block": ([[1, 2, 1], [3, 3, 0]], [20, 12]),
    # past the table's 24 positions: exactly the table is attended
    "index_past_table": ([[1, 2, 3], [4, 5, 6]], [24, 100]),
    # position 0; the last row of a block; the first row of the next
    "edges": ([[1, 2, 0], [3, 0, 0], [4, 5, 0]], [15, 0, 8]),
    # slot 1 inactive: the port gives zeros, only rows 0 and 2 compare
    "inactive": ([[1, 2, 0], [3, 4, 5], [6, 0, 0]], [11, -1, 3]),
}


@pytest.mark.parametrize("li", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas(case, li):
    tables, index = CASES[case]
    q, k, v = _inputs(li, len(tables))
    got = _port(q, k, v, tables, index, li)
    want = _jax(q, k, v, tables, index, li)
    live = np.asarray(index) >= 0
    assert got.dtype == torch.float32 and got.shape == (len(tables), H, HD)
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=ATOL)
    assert not got[torch.as_tensor(~live)].any()  # inactive: exact zeros


@pytest.mark.parametrize("li", [0, 1])
def test_plain_matches_pallas_wide_table(li):
    """Tables of 4096 entries (the CUDA kernel stages them in rounds, with
    no limit on the width): slot 0 past the table (all 32,768 positions),
    slot 1 deep inside it, slot 2 at position 0; entries drawn with
    repeats over the small pool, past each slot's last position trash.
    Tolerance atol/rtol 1e-4, that of the other parity tests: sums of up to
    32,768 terms taken in another order drift past the 2e-5 of the short
    cases."""
    rng = np.random.default_rng(40 + li)
    mb = 4096
    tables = rng.integers(1, NB, (3, mb)).astype(np.int32)
    index = np.array([mb * BS + 3, 2500 * BS + 5, 0], np.int32)
    tables[1, 2501:] = t_paged.TRASH_BLOCK
    tables[2, 1:] = t_paged.TRASH_BLOCK
    q, k, v = _inputs(li, 3)
    got = _port(q, k, v, tables, index, li)
    want = _jax(q, k, v, tables, index, li)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_trash_entries_never_read():
    """The JAX test's garbage case: entries past the allocation (the trash
    block or other blocks) change nothing, with every pool value x100."""
    q, k, v = _inputs(3, 1)
    k, v = 100 * k, 100 * v
    a = _port(q, k, v, [[1, 0, 0]], [5], 0)
    b = _port(q, k, v, [[1, 2, 3]], [5], 0)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), _jax(q, k, v, [[1, 0, 0]], [5], 0),
                               atol=ATOL * 100)


def test_flat_pool_is_the_5d_view():
    """The port's flat (L, NB, BS, H*hd) pool gives what its 5-D view
    gives, bit for bit."""
    tables, index = CASES["jax_test"]
    q, k, v = _inputs(4, len(tables))
    five = _port(q, k, v, tables, index, 1)
    flat = _port(q, k.reshape(L, NB, BS, H * HD), v.reshape(L, NB, BS, H * HD),
                 tables, index, 1)
    assert torch.equal(five, flat)


def test_bf16_matches_pallas():
    """bf16 q and pools, JAX on the same bf16 values: within 2 bf16 ulps."""
    tables, index = CASES["jax_test"]
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16)
               for x in _inputs(5, len(tables)))
    got = t_pa.paged_flash_decode(q, k, v, torch.tensor(tables).int(),
                                  torch.tensor(index).int(), 0)
    want = j_pa.paged_flash_decode(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(tables, jnp.int32), jnp.asarray(index, jnp.int32), 0,
        interpret=True)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    want = torch.tensor(np.array(want.astype(jnp.float32)))
    err, ok = t_pa.compare_kernels(got, want.to(torch.bfloat16),
                                   torch.zeros(len(tables), dtype=torch.bool))
    assert ok, f"max abs err {err}"


def _allocated(alloc, sizes, rng, max_blocks):
    """Tables of ``sizes`` blocks from ``alloc`` (the rest trash) and a
    position drawn inside each allocation; slot 1 inactive."""
    tables = np.full((len(sizes), max_blocks), t_paged.TRASH_BLOCK, np.int32)
    index = np.zeros(len(sizes), np.int32)
    for s, n in enumerate(sizes):
        tables[s, :n] = alloc.alloc(n)
        index[s] = rng.integers(0, n * BS)
    index[1] = -1
    return torch.as_tensor(tables), torch.as_tensor(index)


def test_plain_k7_equals_plain_k3_on_allocator_tables():
    """On tables a ``BlockAllocator`` scattered, K7 equals K3 under the
    visibility the tables give (``serve/paged.py table_visibility``)."""
    nb, rng = 40, np.random.default_rng(6)
    alloc = t_paged.BlockAllocator(nb)
    held = [alloc.alloc(int(rng.integers(1, 5))) for _ in range(8)]
    for i in (0, 2, 5):
        alloc.release(held[i])
    tables, index = _allocated(alloc, [4, 3, 5, 1, 2], rng, 5)
    q, k, v = (torch.as_tensor(x) for x in _inputs(6, 5, nb=nb))
    vis = t_paged.table_visibility(tables, index, nb, BS).to(torch.int8)
    k_flat, v_flat = (x.reshape(L, nb, BS, H * HD) for x in (k, v))
    for li in range(L):
        got = t_pa.paged_flash_decode(q, k, v, tables, index, li)
        want = t_pa.paged_flash_decode_stream_flat(q, k_flat, v_flat, vis, li)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
        assert not got[1].any() and not want[1].any()


def test_plain_k7_equals_plain_k1_on_regions():
    """On ``RegionAllocator`` regions, K7 equals K1 with the region's first
    block as its start."""
    nb, rng = 48, np.random.default_rng(7)
    alloc = t_paged.RegionAllocator(nb, 6)
    alloc.release(alloc.alloc(2))  # a region that came and went
    tables, index = _allocated(alloc, [6, 2, 4, 1], rng, 6)
    q, k, v = (torch.as_tensor(x) for x in _inputs(7, 4, nb=nb))
    k_flat, v_flat = (x.reshape(L, nb, BS, H * HD) for x in (k, v))
    for li in range(L):
        got = t_pa.paged_flash_decode(q, k_flat, v_flat, tables, index, li)
        want = t_pa.paged_flash_decode_owner(q, k_flat, v_flat,
                                             tables[:, 0].contiguous(), index,
                                             li)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


class TestWrapperContract:
    def _args(self):
        tables, index = CASES["jax_test"]
        q, k, v = _inputs(8, len(tables))
        return [torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                torch.tensor(tables, dtype=torch.int32),
                torch.tensor(index, dtype=torch.int32)]

    def test_cpu_tensors_take_the_plain_version(self):
        args = self._args()
        before = t_pa.paged_flash_decode.launches
        assert torch.equal(t_pa.paged_flash_decode(*args, 1),
                           t_pa.paged_flash_decode_ref(*args, 1))
        # a launch counts only a kernel launch
        assert t_pa.paged_flash_decode.launches == before

    def test_non_cpu_non_cuda_tensor_raises(self):
        args = [x.to("meta") for x in self._args()]
        with pytest.raises(ValueError, match="CUDA"):
            t_pa.paged_flash_decode(*args, 0)
