"""The tiled decode kernels' plan on the CPU: ``tiled_decode`` computes K1
(owner) and K7 (block table) as the tiled CUDA kernels in
``csrc/paged_attention.cu`` do, in fp32:

* tiles of min(BS, 64) token rows: of the slot's contiguous region (K1,
  a tile may cross blocks), or of one physical block, from the table's
  entries staged ``round_`` at a time, a block of more than 64 rows cut
  into tiles that never cross it (K7);
* lane groups over the head dimension: a group of ``lanes`` lanes holds
  one key, each lane a slice of its columns, the dot product summed over
  the lanes by an xor tree; group g takes the tile's rows g, g + G, ... in
  batches of ``64 // G`` (one online-softmax update a batch);
* each group's state (running max, denominator, V sum) merged at the end:
  by an xor tree over the groups of a warp, then over the 8 warps in
  order (max, rescale, column sum); a state with no key adds nothing, a
  (slot, head) with no key returns zeros.

The mirror is held to the port's plain versions (fp32 within 1e-5 abs and
rel) and to the JAX package's Pallas kernels in interpret mode (atol/rtol
1e-4, the tolerance of the other parity tests: another reduction order) at
2-3 layers, 2 heads of 64 and 16-, 64- or 100-token blocks. K4 runs the
pipelined design, mirrored in tests/test_torch_split.py. The CUDA kernels
are held against the plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import TOL
from unified_audio_tpu.ops.pallas import paged_attention as j_pa
from unified_audio_tpu_torch.ops.cuda import paged_attention as t_pa
from unified_audio_tpu_torch.serve import paged as t_paged

H, HD, THREADS = 2, 64, 256
EXACT = dict(atol=1e-5, rtol=1e-5)
LANES = {"fp32": 16, "bf16": 8}  # lanes holding one key


def tile_rows_for(bs):
    """Rows of a tile: a block's, at most 64."""
    return min(bs, 64)


def owner_tiles(start, index, bs):
    """K1: the slot's positions 0..index as (first row, rows) tiles of its
    contiguous region."""
    n, rows = max(int(index) + 1, 0), tile_rows_for(bs)
    return [(int(start) * bs + p, min(rows, n - p)) for p in range(0, n, rows)]


def table_tiles(table, index, bs, round_=1024):
    """K7: positions 0..min(index, MB*BS - 1), entries staged ``round_`` at
    a time; position p is row p % BS of block table[p // BS]; a tile never
    crosses a block."""
    rows, mb = tile_rows_for(bs), len(table)
    n = max(min(int(index) + 1, mb * bs), 0)
    n_entries = -(-n // bs)
    tiles = []
    for e0 in range(0, n_entries, round_):
        entries = [int(x) for x in table[e0:e0 + round_]]
        n_round = min(len(entries) * bs, n - e0 * bs)
        for b0 in range(0, n_round, bs):
            tiles += [(entries[b0 // bs] * bs + off,
                       min(rows, bs - off, n_round - b0 - off))
                      for off in range(0, min(bs, n_round - b0), rows)]
    return tiles


def _combine(m, l, acc, m_o, l_o, acc_o):
    """Two online-softmax states as one (a state with m = -inf adds
    nothing)."""
    big = torch.maximum(m, m_o)
    f = torch.where(torch.isinf(m), 0.0, torch.exp(m - big))
    f_o = torch.where(torch.isinf(m_o), 0.0, torch.exp(m_o - big))
    return big, l * f + l_o * f_o, acc * f[..., None] + acc_o * f_o[..., None]


def _lane_dot(q, k, lanes):
    """q (H, 64) . k (H, n, 64) as the lane groups sum it: each lane its
    64 // lanes columns, then an xor tree over the lanes."""
    parts = (q[:, None] * k).reshape(*k.shape[:2], lanes, -1).sum(-1)
    off = lanes // 2
    while off:
        parts = parts + parts[..., torch.arange(lanes) ^ off]
        off //= 2
    return parts[..., 0]


def tiled_decode(q, kpool, vpool, li, tiles, lanes):
    """K1/K7 by the tiled plan: ``tiles`` lists each slot's (first row,
    rows) tiles of the layer; ``lanes`` lanes hold one key. fp32
    throughout, the output in q's dtype."""
    s_slots = q.shape[0]
    groups = THREADS // lanes
    batch = max(1, 64 // groups)
    per_warp = 32 // lanes
    k_layer = kpool[li].reshape(-1, H, HD).float()
    v_layer = vpool[li].reshape(-1, H, HD).float()
    out = torch.zeros(s_slots, H, HD)
    for s in range(s_slots):
        qf = q[s].float()
        m = torch.full((H, groups), -torch.inf)
        l = torch.zeros(H, groups)
        acc = torch.zeros(H, groups, HD)
        for first, rows in tiles[s]:
            for r0 in range(0, rows, groups * batch):
                r = r0 + torch.arange(batch)[:, None] * groups \
                    + torch.arange(groups)  # (batch, G)
                ok = r < rows
                tok = first + r.clamp(max=rows - 1)
                k = k_layer[tok.flatten()].transpose(0, 1)  # (H, B*G, 64)
                logit = _lane_dot(qf, k, lanes).reshape(H, batch, groups)
                logit = (logit * HD ** -0.5).masked_fill(~ok, -torch.inf)
                big = logit.max(1).values  # (H, G)
                m_new = torch.maximum(m, big)
                live = ~torch.isinf(big)  # groups with a key in the batch
                p = torch.exp(logit - torch.where(live, m_new, 0.0)[:, None])
                p = torch.where(ok, p, 0.0)
                v = v_layer[tok.flatten()].transpose(0, 1).reshape(
                    H, batch, groups, HD)
                alpha = torch.exp(m - m_new)
                upd = (acc * alpha[..., None]
                       + (p[..., None] * v).sum(1))
                acc = torch.where(live[..., None], upd, acc)
                l = torch.where(live, l * alpha + p.sum(1), l)
                m = torch.where(live, m_new, m)
        # the groups of a warp by an xor tree, then the warps in order
        m, l, acc = (x.reshape(H, -1, per_warp, *x.shape[2:])
                     for x in (m, l, acc))
        off = 1
        while off < per_warp:
            idx = torch.arange(per_warp) ^ off
            m, l, acc = _combine(m, l, acc, m[:, :, idx], l[:, :, idx],
                                 acc[:, :, idx])
            off *= 2
        m, l, acc = m[:, :, 0], l[:, :, 0], acc[:, :, 0]  # (H, 8, ...)
        big = m.max(1).values
        if bool(torch.isinf(big).all()):
            continue
        f = torch.exp(m - big[:, None])
        out[s] = (acc * f[..., None]).sum(1) / (l * f).sum(1)[:, None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _pools(rng, n_layers, nb, bs):
    shape = (n_layers, nb, bs, H * HD)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _owner_case(bs, seed=0, n_layers=3):
    """Four slots with 4-block regions: one at the region's end, one
    inactive, one at a tile's last row, one at position 0."""
    rng = np.random.default_rng(seed)
    nb = 20
    k, v = _pools(rng, n_layers, nb, bs)
    q = rng.standard_normal((4, H, HD)).astype(np.float32)
    start = np.array([0, 4, 8, 12], np.int32)
    rows = tile_rows_for(bs)
    index = np.array([4 * bs - 1, -1, rows - 1, 0], np.int32)
    return [torch.as_tensor(x) for x in (q, k, v, start, index)]


def _table_case(bs, mb, seed=0, n_layers=2):
    """Four slots: a table repeating a block, an index past the table,
    an inactive slot, a slot at position 0; entries past a slot's last
    position are the trash block, its rows x100."""
    rng = np.random.default_rng(seed)
    nb = 24
    k, v = _pools(rng, n_layers, nb, bs)
    k[:, t_paged.TRASH_BLOCK] *= 100
    v[:, t_paged.TRASH_BLOCK] *= 100
    q = rng.standard_normal((4, H, HD)).astype(np.float32)
    tables = rng.integers(1, nb, (4, mb)).astype(np.int32)
    tables[0, 2] = tables[0, 0]  # logical blocks 0 and 2: one block
    index = np.array([min(3 * bs + 5, mb * bs - 1), mb * bs + 9, -1, 0],
                     np.int32)
    last = np.minimum(index // bs, mb - 1)
    for s in range(4):
        tables[s, max(last[s], 0) + 1:] = t_paged.TRASH_BLOCK
    return [torch.as_tensor(x) for x in (q, k, v, tables, index)]


def _owner_mirror(args, li, lanes):
    q, k, v, start, index = args
    tiles = [owner_tiles(start[s], index[s], k.shape[2])
             for s in range(len(q))]
    return tiled_decode(q, k, v, li, tiles, lanes)


def _table_mirror(args, li, lanes, round_=1024):
    q, k, v, tables, index = args
    tiles = [table_tiles(tables[s], index[s], k.shape[2], round_)
             for s in range(len(q))]
    return tiled_decode(q, k, v, li, tiles, lanes)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_tiles_from_regions():
    """K1's tiles: 64 rows of the region at a time, the last one ragged;
    none for an inactive slot."""
    assert owner_tiles(3, 129, 64) == [(192, 64), (256, 64), (320, 2)]
    assert owner_tiles(2, 15, 16) == [(32, 16)]
    assert owner_tiles(5, -1, 64) == []
    assert owner_tiles(1, 0, 128) == [(128, 1)]
    # 100-token blocks: 64-row tiles across the block boundary
    assert owner_tiles(3, 129, 100) == [(300, 64), (364, 64), (428, 2)]


def test_tiles_from_tables():
    """K7's tiles: positions through the table, entries staged in rounds,
    cut at the table's end; a repeated entry is read twice."""
    table = [4, 2, 4, 9]
    assert table_tiles(table, 37, 16) == [(64, 16), (32, 16), (64, 6)]
    assert table_tiles(table, 37, 16, round_=1) == \
        table_tiles(table, 37, 16)
    assert table_tiles(table, 10 ** 6, 16)[-1] == (144, 16)
    assert len(table_tiles(table, 10 ** 6, 16)) == 4
    assert table_tiles(table, -1, 16) == []
    # 100-token blocks: two tiles a block (64 + 36 rows), none crossing it
    assert table_tiles([4, 2], 150, 100) == [(400, 64), (464, 36),
                                             (200, 51)]
    assert table_tiles([4, 2], 10 ** 6, 100, round_=1) == \
        [(400, 64), (464, 36), (200, 64), (264, 36)]
    # 128-token blocks: 64-row tiles, as many as the positions need
    assert table_tiles([4, 2], 130, 128) == [(512, 64), (576, 64),
                                             (256, 3)]


# ---------------------------------------------------------------------------
# the mirror against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [LANES["fp32"], LANES["bf16"]])
@pytest.mark.parametrize("bs", [16, 64, 100])
@pytest.mark.parametrize("li", [0, 2])
def test_owner_mirror_matches_plain(li, bs, lanes):
    """K1 by the tiled plan (fp32 and bf16 lane groups) equals the plain
    K1; the inactive slot is exact zeros."""
    args = _owner_case(bs)
    got = _owner_mirror(args, li, lanes)
    want = t_pa.paged_flash_decode_owner_ref(*args, li)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT)
    assert not got[1].any()


@pytest.mark.parametrize("lanes", [LANES["fp32"], LANES["bf16"]])
@pytest.mark.parametrize("bs,mb,round_", [(16, 6, 1024), (16, 6, 2),
                                          (64, 3, 1), (16, 4096, 1024),
                                          (16, 4096, 1000), (100, 5, 2)])
def test_table_mirror_matches_plain(bs, mb, round_, lanes):
    """K7 by the tiled plan equals the plain K7: a repeated block, an index
    past the table, trash entries x100 never read; tables of 4096 entries
    (over the 2048 the first port's kernel took), in one round or several;
    100-token blocks, two tiles each."""
    args = _table_case(bs, mb)
    got = _table_mirror(args, 1, lanes, round_)
    want = t_pa.paged_flash_decode_ref(*args, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT)
    assert not got[2].any()


def test_mirror_every_state_empty():
    """No active slot (K1), every slot inactive (K7): every group's state is
    empty, the merge gives exact zeros, no NaN."""
    args = _owner_case(16)
    args[4] = torch.full((4,), -1, dtype=torch.int32)
    assert torch.equal(_owner_mirror(args, 0, 8), torch.zeros(4, H, HD))
    args = _table_case(16, 6)
    args[4] = torch.full((4,), -1, dtype=torch.int32)
    assert torch.equal(_table_mirror(args, 0, 16), torch.zeros(4, H, HD))


# ---------------------------------------------------------------------------
# the mirror against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("li", [0, 2])
def test_owner_mirror_matches_pallas(li, bs):
    """K1's mirror against the Pallas K1 on the active slots (the Pallas
    kernel returns the mean of V on an inactive one)."""
    args = _owner_case(bs)
    q, k, v, start, index = (x.numpy() for x in args)
    want = np.asarray(j_pa.paged_flash_decode_owner(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(start),
        jnp.asarray(index), li, num_heads=H, chunk_blocks=2, max_chunks=2,
        interpret=True))
    got = _owner_mirror(args, li, LANES["bf16"]).numpy()
    live = index >= 0
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("bs,mb", [(16, 6), (64, 3), (16, 4096)])
def test_table_mirror_matches_pallas(bs, mb):
    """K7's mirror against the Pallas K7 on the active slots (the Pallas
    kernel returns the mean of V over the table on an inactive one)."""
    args = _table_case(bs, mb)
    q, k, v, tables, index = (x.numpy() for x in args)
    five = [x.reshape(*x.shape[:3], H, HD) for x in (k, v)]
    want = np.asarray(j_pa.paged_flash_decode(
        jnp.asarray(q), *(jnp.asarray(x) for x in five), jnp.asarray(tables),
        jnp.asarray(index), 1, interpret=True))
    got = _table_mirror(args, 1, LANES["fp32"]).numpy()
    live = index >= 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
