"""Stream flash-decode K3/K4: the port's plain versions against the JAX
package's Pallas kernels (interpret mode, as tests/test_pallas_kernels.py
runs them).

Four slots over a pool of 16 four-token blocks, tables scattered as a
``BlockAllocator`` hands them out: a slot whose prefix ends inside a block,
an inactive slot with no table (a row with no visible key), a slot whose
only visible keys lie in the pool's last block (the last chunk), and a slot
whose prefix ends on a block boundary. The visibility mask is the JAX
package's ``visibility_mask``. Bounds and chunks: the whole pool in four
chunks or in one, and a bound of half the pool in four chunks (the slot of
the last block then sees nothing). Tolerance: atol/rtol 1e-4 (another
reduction order) on the rows with a visible key; the port returns zeros on
the others (the TPU kernel returns the mean of V there). The CUDA kernels
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

L, NB, BS, H, HD = 2, 16, 4, 2, 8
TABLES = [[3, 9, 5], [], [15], [1, 12]]
INDEX = np.array([9, 0, 2, 7], np.int32)


def _vis(nb):
    lmap = np.full((len(TABLES), NB), -1, np.int32)
    for s, blocks in enumerate(TABLES):
        lmap[s, blocks] = np.arange(len(blocks))
    return np.asarray(j_pa.visibility_mask(jnp.asarray(lmap[:, :nb]),
                                           jnp.asarray(INDEX), BS))


def _inputs(seed, quant):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(TABLES), H, HD)).astype(np.float32)
    shape = (L, NB, BS, H * HD)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (0.02 * rng.random((L, NB, BS))).astype(np.float32)
        vs = (0.02 * rng.random((L, NB, BS))).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, None, None


def _check(got, want, vis):
    seen = vis.any(1)
    assert seen.tolist() == [True, False, bool(vis[2].any()), True]
    np.testing.assert_allclose(got.numpy()[seen], np.asarray(want)[seen],
                               **TOL)
    assert not got[~torch.as_tensor(seen)].any()  # no visible key: zeros


@pytest.mark.parametrize("chunk,nb", [(4, 16), (16, 16), (4, 8)])
@pytest.mark.parametrize("li", [0, 1])
class TestPlainVersusPallas:
    def test_k3(self, chunk, nb, li):
        q, k, v, _, _ = _inputs(li, quant=False)
        vis = _vis(nb)
        want = j_pa.paged_flash_decode_stream_flat(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vis),
            li, num_heads=H, chunk_blocks=chunk, num_active_blocks=nb,
            interpret=True)
        got = t_pa.paged_flash_decode_stream_flat(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            torch.as_tensor(vis), li, nb)
        _check(got, want, vis != 0)

    def test_k4(self, chunk, nb, li):
        q, k, v, ks, vs = _inputs(10 + li, quant=True)
        vis = _vis(nb)
        want = j_pa.paged_flash_decode_stream_flat_q8(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(ks[li]), jnp.asarray(vs[li]), jnp.asarray(vis), li,
            num_heads=H, chunk_blocks=chunk, num_active_blocks=nb,
            interpret=True)
        got = t_pa.paged_flash_decode_stream_flat_q8(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            torch.as_tensor(ks[li]), torch.as_tensor(vs[li]),
            torch.as_tensor(vis), li, nb)
        _check(got, want, vis != 0)


def test_visibility_mask_matches_jax():
    """The port's mask (bool) equals the JAX package's (int8) on the same
    inverse block map."""
    lmap = np.full((len(TABLES), NB), -1, np.int64)
    for s, blocks in enumerate(TABLES):
        lmap[s, blocks] = np.arange(len(blocks))
    got = t_paged.visibility_mask(torch.as_tensor(lmap),
                                  torch.as_tensor(INDEX), BS)
    np.testing.assert_array_equal(got.numpy(), _vis(NB) != 0)


class TestWrapperContract:
    def _args(self):
        q, k, v, _, _ = _inputs(0, quant=False)
        return [torch.as_tensor(x) for x in (q, k, v, _vis(NB))]

    def test_cpu_tensors_take_the_plain_version(self):
        args = self._args()
        before = t_pa.paged_flash_decode_stream_flat.launches
        out = t_pa.paged_flash_decode_stream_flat(*args, 1, NB)
        ref = t_pa.paged_flash_decode_stream_flat_ref(*args, 1, NB)
        assert torch.equal(out, ref)
        # the bound defaults to the whole pool
        assert torch.equal(t_pa.paged_flash_decode_stream_flat(*args, 1), ref)
        # a launch counts only a kernel launch
        assert t_pa.paged_flash_decode_stream_flat.launches == before

    def test_bound_and_mask_are_checked(self):
        q, k, v, vis = self._args()
        with pytest.raises(ValueError, match="outside the pool"):
            t_pa.paged_flash_decode_stream_flat(q, k, v, vis, 0, NB + 1)
        with pytest.raises(ValueError, match="visibility shape"):
            t_pa.paged_flash_decode_stream_flat(q, k, v, vis, 0, NB // 2)

    def test_non_cpu_non_cuda_tensor_raises(self):
        args = [x.to("meta") for x in self._args()]
        with pytest.raises(ValueError, match="CUDA"):
            t_pa.paged_flash_decode_stream_flat(*args, 0, NB)
