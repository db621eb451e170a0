"""The decode kernels' partial-state arithmetic on the CPU: ``split_merge``
computes the owner int8 decode (K2) and the stream decode over a float
(K3) or an int8 pool (K4) as P partial states, tile g of a slot's keys going to state g % P, each an
online softmax (running max, denominator, p-weighted V sum), merged in
state order. The CUDA kernels do this with P = the threads of a (slot,
head) block and tiles of one key. It is held against the plain versions
(fp32, within 1e-6) for P in {1, 2, 3, 8, 14} and at a kernel's 256
threads, with states left empty, an inactive slot and a row with no
visible key (exact zeros, no NaN), and against the JAX package's Pallas
kernels in interpret mode (atol/rtol 1e-4, another reduction order). The
kernels themselves are held against the plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import TOL
from unified_audio_tpu.ops.pallas import paged_attention as j_pa
from unified_audio_tpu_torch.ops.cuda import paged_attention as t_pa

L, NB, BS, H, HD = 2, 16, 4, 2, 8
START = np.array([4, 8, 12, 0], np.int32)
INDEX = np.array([9, 7, -1, 0], np.int32)  # mid-tile, tile end, inactive, 0
TABLES = [[3, 9, 5], [], [15], [1, 12]]
STREAM_INDEX = np.array([9, 0, 2, 7], np.int32)
SPLITS = [1, 2, 3, 8, 14]
EXACT = dict(atol=1e-6, rtol=1e-6)



def _slot_tiles(bs, rows, stream, start=None, last=None, seen=None):
    """The (first row in the layer, rows) of one slot's tiles in the order
    they are dealt out: owner, positions 0..last from the region's first
    row in tiles of ``rows``; stream, each block holding a visible key in
    ``seen`` (bool, the slot's mask row), in block order, cut into tiles of
    ``rows``."""
    if not stream:
        n_pos = max(last + 1, 0)
        return [(start * bs + g, min(rows, n_pos - g))
                for g in range(0, n_pos, rows)]
    live = seen.reshape(-1, bs).any(1).nonzero().flatten().tolist()
    return [(b * bs + off, min(rows, bs - off))
            for b in live for off in range(0, bs, rows)]


def split_merge(q, kpool, vpool, li, splits, start_block=None, index=None,
                vis=None, k_scale=None, v_scale=None, num_active_blocks=None,
                rows=1):
    """K2's function (``start_block``/``index`` and the int8 pool's
    ``k_scale``/``v_scale``) or K3's (``vis``, the bound
    ``num_active_blocks``) as ``splits`` partial states, tile g of a slot
    (``rows`` keys) going to state g % ``splits``, merged in state order. A
    state with no key holds m = -inf, l = 0 and adds nothing; a slot with no
    key returns zeros. fp32 throughout, the output in q's dtype."""
    stream = vis is not None
    bs = kpool.shape[2]
    if stream:
        nb = kpool.shape[1] if num_active_blocks is None \
            else int(num_active_blocks)
        seen_all = vis[:, :nb * bs] != 0
    s_slots, h, hd = q.shape
    k_layer = kpool[li].reshape(-1, h, hd).float()
    v_layer = vpool[li].reshape(-1, h, hd).float()
    ksc = None if k_scale is None else k_scale.reshape(-1).float()
    vsc = None if v_scale is None else v_scale.reshape(-1).float()
    out = torch.zeros(s_slots, h, hd)
    for s in range(s_slots):
        tiles = _slot_tiles(
            bs, rows, stream,
            start=None if stream else int(start_block[s]),
            last=None if stream else int(index[s]),
            seen=seen_all[s] if stream else None)
        parts = []
        for r in range(splits):
            toks = [tok + i for tok, n in tiles[r::splits] for i in range(n)]
            toks = torch.tensor(toks, dtype=torch.long)
            if stream and len(toks):
                toks = toks[seen_all[s, toks]]
            if not len(toks):
                parts.append((torch.full((h,), -torch.inf), torch.zeros(h),
                              torch.zeros(h, hd)))
                continue
            dots = torch.einsum("hd,phd->hp", q[s].float(), k_layer[toks])
            logits = (dots * (ksc[toks] * hd ** -0.5) if ksc is not None
                      else dots * hd ** -0.5)
            m = logits.max(1).values
            p = torch.exp(logits - m[:, None])
            pv = p * vsc[toks] if vsc is not None else p
            parts.append((m, p.sum(1),
                          torch.einsum("hp,phd->hd", pv, v_layer[toks])))
        big = torch.stack([m for m, _, _ in parts]).max(0).values
        if bool(torch.isinf(big).all()):
            continue  # no key at all: zeros
        num = torch.zeros(h, hd)
        den = torch.zeros(h)
        for m, l, acc in parts:
            w = torch.where(torch.isinf(m), 0.0, torch.exp(m - big))
            num = num + acc * w[:, None]
            den = den + l * w
        out[s] = num / den[:, None]
    return out.to(q.dtype)


def _pools(seed, quant):
    rng = np.random.default_rng(seed)
    shape = (L, NB, BS, H * HD)
    q = rng.standard_normal((4, H, HD)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (0.02 * rng.random((NB, BS))).astype(np.float32)
        vs = (0.02 * rng.random((NB, BS))).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, None, None


def _vis(nb):
    """The (4, nb * BS) int8 mask of TABLES and STREAM_INDEX (slot 1 sees
    nothing; under a bound of 8 blocks slot 2 sees nothing either)."""
    lmap = np.full((len(TABLES), NB), -1, np.int32)
    for s, blocks in enumerate(TABLES):
        lmap[s, blocks] = np.arange(len(blocks))
    return np.array(j_pa.visibility_mask(jnp.asarray(lmap[:, :nb]),
                                         jnp.asarray(STREAM_INDEX), BS))


def _owner(seed=0, li=1):
    q, k, v, ks, vs = _pools(seed, quant=True)
    return [torch.as_tensor(x) for x in (q, k, v, ks, vs, START, INDEX)] + [li]


def _mirror_owner(args, splits, rows=1):
    q, k, v, ks, vs, start, index, li = args
    return split_merge(q, k, v, li, splits, start_block=start, index=index,
                       k_scale=ks, v_scale=vs, rows=rows)


def _stream(seed=0, li=1, nb=NB):
    q, k, v, _, _ = _pools(seed, quant=False)
    return [torch.as_tensor(x) for x in (q, k, v, _vis(nb))] + [li, nb]


def _mirror_stream(args, splits, rows=1):
    q, k, v, vis, li, nb = args
    return split_merge(q, k, v, li, splits, vis=vis, num_active_blocks=nb,
                       rows=rows)


def _stream_q8(seed=0, li=1, nb=NB):
    q, k, v, ks, vs = _pools(seed, quant=True)
    return [torch.as_tensor(x) for x in (q, k, v, ks, vs, _vis(nb))] + \
        [li, nb]


def _mirror_stream_q8(args, splits, rows=1):
    q, k, v, ks, vs, vis, li, nb = args
    return split_merge(q, k, v, li, splits, vis=vis, k_scale=ks, v_scale=vs,
                       num_active_blocks=nb, rows=rows)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_owner_mirror_matches_plain(splits, rows):
    """K2 as ``splits`` partial states in tiles of ``rows`` positions equals
    the plain K2: positions 0..9 and 0..7 over 4-token blocks, an inactive
    slot and a slot at position 0; many splits hold no tile."""
    args = _owner()
    got = _mirror_owner(args, splits, rows)
    want = t_pa.paged_flash_decode_owner_q8_ref(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT)
    assert not got[2].any()  # inactive: exact zeros


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("nb", [NB, NB // 2])
def test_stream_mirror_matches_plain(splits, nb):
    """K3 as ``splits`` partial states equals the plain K3 over the whole
    pool and under a bound of half of it, with a row that sees nothing
    (exact zeros, no NaN) and a partly masked last block."""
    args = _stream(nb=nb)
    got = _mirror_stream(args, splits, rows=2)
    want = t_pa.paged_flash_decode_stream_flat_ref(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT)
    empty = ~(args[3] != 0).any(1)
    assert bool(empty[1]) and not got[empty].any()


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("nb", [NB, NB // 2])
def test_stream_q8_mirror_matches_plain(splits, nb):
    """K4 (the stream decode over an int8 pool, the scales folded by row) as
    ``splits`` partial states equals the plain K4 over the whole pool and
    under a bound of half of it; the row that sees nothing is exact
    zeros."""
    args = _stream_q8(nb=nb)
    got = _mirror_stream_q8(args, splits, rows=2)
    want = t_pa.paged_flash_decode_stream_flat_q8_ref(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT)
    empty = ~(args[5] != 0).any(1)
    assert bool(empty[1]) and not got[empty].any()


@pytest.mark.parametrize("splits", [1, 8, 14])
def test_mirror_every_split_empty(splits):
    """No active slot (owner) and an all-zero mask (stream): every split's
    state is empty, the merge gives exact zeros and no NaN."""
    args = _owner()
    args[6] = torch.full((4,), -1, dtype=torch.int32)
    got = _mirror_owner(args, splits)
    assert torch.equal(got, torch.zeros_like(got))
    args = _stream()
    args[3] = torch.zeros_like(args[3])
    got = _mirror_stream(args, splits)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("splits", [3, 8])
@pytest.mark.parametrize("li", [0, 1])
def test_owner_mirror_matches_pallas(splits, li):
    """The K2 mirror against the Pallas K2 in interpret mode on the active
    slots (the Pallas kernel returns the mean of V on an inactive one)."""
    q, k, v, ks, vs = _pools(10 + li, quant=True)
    start, index = START[:3], INDEX[:3]
    want = j_pa.paged_flash_decode_owner_q8(
        jnp.asarray(q[:3]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(start), jnp.asarray(index), li,
        num_heads=H, chunk_blocks=2, max_chunks=2, interpret=True)
    got = split_merge(
        torch.as_tensor(q[:3]), torch.as_tensor(k), torch.as_tensor(v), li,
        splits, start_block=torch.as_tensor(start),
        index=torch.as_tensor(index), k_scale=torch.as_tensor(ks),
        v_scale=torch.as_tensor(vs), rows=3)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)


@pytest.mark.parametrize("splits", [3, 8])
@pytest.mark.parametrize("li", [0, 1])
def test_stream_mirror_matches_pallas(splits, li):
    """The K3 mirror against the Pallas K3 in interpret mode on the rows
    with a visible key."""
    q, k, v, _, _ = _pools(li, quant=False)
    vis = _vis(NB)
    want = j_pa.paged_flash_decode_stream_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vis), li,
        num_heads=H, chunk_blocks=4, num_active_blocks=NB, interpret=True)
    got = split_merge(torch.as_tensor(q), torch.as_tensor(k),
                      torch.as_tensor(v), li, splits,
                      vis=torch.as_tensor(vis), rows=2)
    seen = (vis != 0).any(1)
    np.testing.assert_allclose(got.numpy()[seen], np.asarray(want)[seen],
                               **TOL)


@pytest.mark.parametrize("splits", [3, 8])
@pytest.mark.parametrize("li", [0, 1])
def test_stream_q8_mirror_matches_pallas(splits, li):
    """The K4 mirror against the Pallas K4 in interpret mode on the rows
    with a visible key."""
    q, k, v, ks, vs = _pools(20 + li, quant=True)
    vis = _vis(NB)
    want = j_pa.paged_flash_decode_stream_flat_q8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(vis), li, num_heads=H, chunk_blocks=4,
        num_active_blocks=NB, interpret=True)
    got = split_merge(torch.as_tensor(q), torch.as_tensor(k),
                      torch.as_tensor(v), li, splits,
                      vis=torch.as_tensor(vis), k_scale=torch.as_tensor(ks),
                      v_scale=torch.as_tensor(vs), rows=2)
    seen = (vis != 0).any(1)
    np.testing.assert_allclose(got.numpy()[seen], np.asarray(want)[seen],
                               **TOL)


def test_split_plan_stream_q8():
    """K4's dealing in its pipelined kernel: thread t of a (slot, head)
    block keeps keys t, t + 256, ... of the live blocks; the merge equals
    the plain K4."""
    args = _stream_q8()
    np.testing.assert_allclose(
        _mirror_stream_q8(args, 256).numpy(),
        t_pa.paged_flash_decode_stream_flat_q8_ref(*args).numpy(), **EXACT)


def test_split_plan():
    """The kernels' own dealing: each of a (slot, head) block's 256 threads
    keeps the state of keys t, t + 256, ... (tiles of one key), most of
    them empty at these sizes; the merge equals the plain K2 and K3."""
    args = _owner()
    np.testing.assert_allclose(
        _mirror_owner(args, 256).numpy(),
        t_pa.paged_flash_decode_owner_q8_ref(*args).numpy(), **EXACT)
    args = _stream()
    np.testing.assert_allclose(
        _mirror_stream(args, 256).numpy(),
        t_pa.paged_flash_decode_stream_flat_ref(*args).numpy(), **EXACT)
