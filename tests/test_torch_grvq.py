"""The port's AutoGroup (residual) vector quantization
(``unified_audio_tpu_torch/ops/grvq.py``) against the JAX package's, on
the CPU, mirroring ``tests/test_grvq_adaptive_tok.py``: the fused two-group
indices ``a * codebook_size + b`` exactly equal to JAX's, z_q and the
losses within 1e-4, ``decode_indices`` equal to z_q (1e-5, 1e-4 with the
temporal residual's cumulative sum, JAX's own bounds); the temporal
residual (a diff before the search, a cumsum after); the residual stack;
and the token maps, which the JAX file also checks."""
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables, to_torch
from unified_audio_tpu.ops import grvq as j_grvq
from unified_audio_tpu_torch.ops import grvq as t_grvq
from unified_audio_tpu_torch.utils import convert as t_convert


def _pair(cls, shape, seed, **kw):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(shape).astype(np.float32)
    jm = getattr(j_grvq, cls)(input_dim=16, codebook_size=32,
                              codebook_dim=8, **kw)
    variables = random_variables(jm, z, seed=seed + 1)
    tm = getattr(t_grvq, cls)(16, 32, 8, **kw)
    tm.load_state_dict(to_torch(t_convert.grvq_state_dict(variables)))
    want = {k: np.asarray(v) for k, v in jm.apply(variables, z).items()}
    with torch.no_grad():
        got = {k: v.numpy() for k, v in tm(torch.as_tensor(z)).items()}
    return jm, variables, tm, z, got, want


def _assert_equal_to_jax(got, want):
    np.testing.assert_array_equal(got["indices"], want["indices"])
    for k in ("z_q", "commitment_loss", "codebook_loss"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_vq_forward_and_decode(seed):
    jm, variables, tm, z, got, want = _pair(
        "AutoGroupVectorQuantize", (2, 10, 16), seed)
    assert got["z_q"].shape == z.shape and got["indices"].shape == (2, 10)
    assert got["indices"].max() < 32 * 32
    _assert_equal_to_jax(got, want)
    with torch.no_grad():
        dec = tm.decode_indices(torch.as_tensor(got["indices"])).numpy()
    np.testing.assert_allclose(got["z_q"], dec, atol=1e-5)


def test_temporal_residual_roundtrip():
    jm, variables, tm, z, got, want = _pair(
        "AutoGroupVectorQuantize", (1, 6, 16), 2, frame_residual_vq=True)
    _assert_equal_to_jax(got, want)
    with torch.no_grad():
        dec = tm.decode_indices(torch.as_tensor(got["indices"])).numpy()
    np.testing.assert_allclose(got["z_q"], dec, atol=1e-4)
    jdec = jm.apply(variables, want["indices"], method="decode_indices")
    np.testing.assert_allclose(dec, np.asarray(jdec), **TOL)


@pytest.mark.parametrize("frame_residual_vq", [False, True])
def test_residual_stack(frame_residual_vq):
    jm, variables, tm, z, got, want = _pair(
        "AutoGroupResidualVectorQuantize", (2, 8, 16), 4, num_quantizers=2,
        frame_residual_vq=frame_residual_vq)
    assert got["indices"].shape == (2, 8, 2)
    _assert_equal_to_jax(got, want)
    with torch.no_grad():
        dec = tm.decode_indices(torch.as_tensor(got["indices"])).numpy()
    np.testing.assert_allclose(got["z_q"], dec, atol=1e-4)


def test_straight_through_gradients():
    """The codes pass the gradient straight through to the projections,
    as ``z + stop_gradient(z_q - z)`` does in JAX."""
    _, _, tm, z, _, _ = _pair("AutoGroupVectorQuantize", (1, 4, 16), 5)
    zt = torch.as_tensor(z).requires_grad_(True)
    out = tm(zt)
    (out["z_q"].sum() + out["commitment_loss"].sum()).backward()
    assert zt.grad is not None and zt.grad.abs().sum() > 0
    assert tm.in_proj_a.weight.grad.abs().sum() > 0


def test_token_parser_maps():
    """Mirrors the JAX file's ``test_token_parser_maps`` on the port's
    copy."""
    from unified_audio_tpu_torch.utils.token_parser import (
        EMO_MAP, GENDER_MAP, TASK_TOKEN_MAP, global_token_string)

    assert TASK_TOKEN_MAP["se"] == "<|task_se|>"
    assert GENDER_MAP["male"] == 1 and EMO_MAP["NEUTRAL"] == 1
    assert global_token_string([1, 2]) == (
        "<|bicodec_global_1|><|bicodec_global_2|>")
