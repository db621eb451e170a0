"""The port's VQ nearest-code search (``ops/cuda/vq.py`` and
``ops/quant.py``) against the JAX package on the CPU.

The plain versions of K5/K6 must give exactly the codes of the JAX XLA
path (``ops/quant.py nearest_code``, ``ResidualVQ.encode``) and of the TPU
kernels run in interpret mode, as tests/test_pallas_kernels.py pins those
two together. The CUDA kernels themselves run on the card only
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_audio_tpu.ops import quant as j_quant
from unified_audio_tpu.ops.pallas import vq_kernel
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.ops.cuda import vq


def _data(seed, m, n, d, nq=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    shape = (n, d) if nq is None else (nq, n, d)
    return x, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,n,d", [(700, 256, 64), (250, 1024, 32)])
def test_nearest_code_matches_jax(m, n, d):
    x, cb = _data(0, m, n, d)
    want = np.asarray(j_quant.nearest_code(jnp.asarray(x), jnp.asarray(cb)))
    kernel = np.asarray(vq_kernel.nearest_code_pallas(
        jnp.asarray(x), jnp.asarray(cb), interpret=True))
    got = vq.nearest_code(torch.as_tensor(x), torch.as_tensor(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kernel)


def test_rvq_encode_matches_jax():
    """Fused and staged plain RVQ encode == the JAX module's encode and
    both TPU kernels in interpret mode (4 layers of 32 codes of dim 16)."""
    m = j_quant.ResidualVQ(dim=16, codebook_size=32, num_quantizers=4,
                           kmeans_init=False)
    x = np.random.default_rng(1).standard_normal((2, 40, 16)).astype(
        np.float32)
    variables = m.init({"params": jax.random.PRNGKey(0),
                        "quant": jax.random.PRNGKey(1)}, x, train=False)
    want = np.asarray(m.apply(variables, x, method="encode"))
    cbs = np.stack([np.asarray(variables["codebook"][f"layers_{i}"]["embed"])
                    for i in range(4)])
    fused = np.asarray(vq_kernel.rvq_encode_fused_pallas(
        jnp.asarray(x), jnp.asarray(cbs), interpret=True))
    staged = np.asarray(vq_kernel.rvq_encode_pallas(
        jnp.asarray(x), jnp.asarray(cbs), interpret=True))
    tx, tcbs = torch.as_tensor(x.reshape(-1, 16)), torch.as_tensor(cbs)
    for got in (vq.rvq_encode_fused(tx, tcbs), vq.rvq_encode_staged(tx, tcbs)):
        got = got.numpy().reshape(2, 40, 4)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, fused)
        np.testing.assert_array_equal(got, staged)

    port = t_quant.ResidualVQ(16, 32, 4)
    for i, layer in enumerate(port.layers):
        layer._codebook.embed.copy_(torch.as_tensor(cbs[i])[None])
    np.testing.assert_array_equal(port.encode(torch.as_tensor(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        port.layers[0].encode(torch.as_tensor(x)).numpy(),
        np.asarray(j_quant.nearest_code(jnp.asarray(x), jnp.asarray(cbs[0]))))
    np.testing.assert_allclose(
        port.decode(torch.as_tensor(np.array(want))).numpy(),
        np.asarray(m.apply(variables, want, method="decode")), atol=1e-6)


def test_exact_tie_goes_to_lower_index():
    """Codes 1 and 3 are the same vector: the lower index wins, in the
    plain version as in JAX's argmin."""
    rng = np.random.default_rng(2)
    cb = rng.standard_normal((5, 8)).astype(np.float32)
    cb[3] = cb[1]
    x = np.stack([cb[1], cb[1] + 1e-3, -cb[1]])
    want = np.asarray(j_quant.nearest_code(jnp.asarray(x), jnp.asarray(cb)))
    got = vq.nearest_code(torch.as_tensor(x), torch.as_tensor(cb)).numpy()
    assert got[0] == got[1] == 1
    np.testing.assert_array_equal(got, want)


def test_residual_vq_decode_minus_one_contributes_zero():
    """A code of -1 (quantizer dropout) adds nothing, as in the JAX
    package."""
    m = j_quant.ResidualVQ(dim=8, codebook_size=16, num_quantizers=3,
                           kmeans_init=False)
    x = np.zeros((1, 4, 8), np.float32)
    variables = m.init({"params": jax.random.PRNGKey(0),
                        "quant": jax.random.PRNGKey(1)}, x, train=False)
    codes = np.array([[[3, -1, 5], [-1, -1, -1], [0, 15, -1], [7, 2, 9]]],
                     np.int32)
    want = np.asarray(m.apply(variables, codes, method="decode"))
    port = t_quant.ResidualVQ(8, 16, 3)
    for i, layer in enumerate(port.layers):
        layer._codebook.embed.copy_(torch.as_tensor(np.array(
            variables["codebook"][f"layers_{i}"]["embed"]))[None])
    got = port.decode(torch.as_tensor(codes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[0, 1] == 0).all()


def test_cpu_takes_plain_version_and_other_devices_raise(monkeypatch):
    """A CPU tensor runs the plain version (and counts no launch); a
    tensor on a device that is neither the CPU nor CUDA raises."""
    x, cb = _data(3, 20, 16, 32, nq=2)
    calls = []
    ref = vq.rvq_encode_fused_ref
    monkeypatch.setattr(vq, "rvq_encode_fused_ref",
                        lambda *a: calls.append(1) or ref(*a))
    before = (vq.nearest_code.launches, vq.rvq_encode_fused.launches)
    vq.rvq_encode_fused(torch.as_tensor(x), torch.as_tensor(cb))
    vq.nearest_code(torch.as_tensor(x), torch.as_tensor(cb[0]))
    assert calls == [1]
    assert (vq.nearest_code.launches, vq.rvq_encode_fused.launches) == before
    meta_x = torch.empty(20, 32, device="meta")
    for fn, books in ((vq.nearest_code, torch.empty(16, 32, device="meta")),
                      (vq.rvq_encode_fused,
                       torch.empty(2, 16, 32, device="meta"))):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(meta_x, books)


def test_judge_codes_flags_a_wrong_code():
    """The card check's rule: plain codes pass; a code moved to a far
    codebook row fails."""
    x, cbs = _data(4, 30, 64, 16, nq=3)
    tx, tcbs = torch.as_tensor(x), torch.as_tensor(cbs)
    codes = vq.rvq_encode_fused_ref(tx, tcbs)
    assert vq.judge_codes(tx, tcbs, codes) == (1.0, 0.0, True)
    bad = codes.clone()
    bad[5, 1] = (bad[5, 1] + 7) % 64
    share, worst, ok = vq.judge_codes(tx, tcbs, bad)
    assert share < 1.0 and worst > 0 and not ok
