"""Owner flash-decode K1/K2: the port's plain versions against the JAX
package's Pallas kernels (interpret mode, as tests/test_pallas_kernels.py
runs them).

Shapes are a few elements: three slots with one live prefix that ends
inside a chunk, one that ends exactly on a chunk boundary and one inactive
slot (index -1), over multi-chunk and single-chunk regions. Tolerance:
atol/rtol 1e-4 (different reduction order). The port returns zeros for an
inactive slot, the documented contract; only active rows are compared with
the interpret-mode kernel. The CUDA kernels are held against the plain
versions on the card in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_common import TOL
from unified_audio_tpu.ops.pallas import paged_attention as j_pa
from unified_audio_tpu_torch.ops.cuda import paged_attention as t_pa

L, NB, BS, H, HD = 2, 16, 4, 2, 8
START = np.array([4, 8, 12], np.int32)   # region-aligned contiguous starts
INDEX = np.array([9, 7, -1], np.int32)   # mid-chunk, chunk end, inactive


def _inputs(seed, quant):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, H, HD)).astype(np.float32)
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


@pytest.mark.parametrize("chunk", [2, 4])  # 2 chunks per region, or 1
@pytest.mark.parametrize("li", [0, 1])
class TestPlainVersusPallas:
    def test_k1(self, chunk, li):
        q, k, v, _, _ = _inputs(li, quant=False)
        want = j_pa.paged_flash_decode_owner(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(START), jnp.asarray(INDEX), li, num_heads=H,
            chunk_blocks=chunk, max_chunks=4 // chunk, interpret=True)
        got = t_pa.paged_flash_decode_owner(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            torch.as_tensor(START), torch.as_tensor(INDEX), li)
        np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                                   **TOL)
        assert not got[2].any()  # inactive slot: zeros

    def test_k2(self, chunk, li):
        q, k, v, ks, vs = _inputs(10 + li, quant=True)
        want = j_pa.paged_flash_decode_owner_q8(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(ks[li]), jnp.asarray(vs[li]), jnp.asarray(START),
            jnp.asarray(INDEX), li, num_heads=H, chunk_blocks=chunk,
            max_chunks=4 // chunk, interpret=True)
        got = t_pa.paged_flash_decode_owner_q8(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            torch.as_tensor(ks[li]), torch.as_tensor(vs[li]),
            torch.as_tensor(START), torch.as_tensor(INDEX), li)
        np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                                   **TOL)
        assert not got[2].any()


class TestWrapperContract:
    def test_cpu_tensors_take_the_plain_version(self):
        q, k, v, _, _ = _inputs(0, quant=False)
        before = t_pa.paged_flash_decode_owner.launches
        args = [torch.as_tensor(x) for x in (q, k, v, START, INDEX)]
        out = t_pa.paged_flash_decode_owner(*args, 1)
        ref = t_pa.paged_flash_decode_owner_ref(*args, 1)
        assert torch.equal(out, ref)
        # a launch counts only a kernel launch
        assert t_pa.paged_flash_decode_owner.launches == before

    def test_non_cpu_non_cuda_tensor_raises(self):
        q, k, v, _, _ = _inputs(0, quant=False)
        args = [torch.as_tensor(x, device="meta") for x in (q, k, v, START,
                                                            INDEX)]
        with pytest.raises(ValueError, match="CUDA"):
            t_pa.paged_flash_decode_owner(*args, 0)
