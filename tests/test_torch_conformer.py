"""The port's conformer (``unified_audio_tpu_torch/models/lm/conformer.py``)
against the JAX package's, on the CPU, mirroring ``tests/test_lm.py
TestConformer``: the encoder's output, the joint attention's two streams
(padded sample rows zeroed, padded keys without influence, the context
never masked) and its context-pre-only mode, each within 1e-4 of JAX on
the same seeded weights (``utils/convert.py conformer_state_dict``)."""
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables, to_torch
from unified_audio_tpu.models.lm import conformer as j_conf
from unified_audio_tpu.nn.transformer import rope_cos_sin as j_rope
from unified_audio_tpu_torch.models.lm import conformer as t_conf
from unified_audio_tpu_torch.nn.transformer import rope_cos_sin
from unified_audio_tpu_torch.utils import convert as t_convert


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("kernel", [31, 5])
def test_encoder_equals_jax(kernel):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    jm = j_conf.ConformerEncoder(num_layers=2, dim=32, heads=4, dim_head=8,
                                 depthwise_conv_kernel_size=kernel)
    variables = random_variables(jm, x, seed=1)
    want = np.asarray(jm.apply(variables, x))
    tm = t_conf.ConformerEncoder(num_layers=2, dim=32, heads=4, dim_head=8,
                                 depthwise_conv_kernel_size=kernel)
    tm.load_state_dict(to_torch(t_convert.conformer_state_dict(variables)))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def _joint(context_pre_only=False, dim=32, heads=4, dh=8, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, dim)).astype(np.float32)
    c = rng.standard_normal((2, 4, dim)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], bool)
    jm = j_conf.JointAttention(dim=dim, heads=heads, dim_head=dh,
                               context_pre_only=context_pre_only)
    rope, c_rope = j_rope(np.arange(6), dh), j_rope(np.arange(4), dh)
    variables = random_variables(jm, x, c, mask, rope, c_rope, seed=seed)
    tm = t_conf.JointAttention(dim, heads, dh, context_pre_only)
    tm.load_state_dict(to_torch(
        t_convert.joint_attention_state_dict(variables)))
    return jm, variables, tm, x, c, mask, dh


def test_joint_attention_equals_jax():
    """Both streams within 1e-4 of JAX; padded sample rows zeroed, a padded
    row's value has no influence on the others or on the context."""
    jm, variables, tm, x, c, mask, dh = _joint()
    rope, c_rope = j_rope(np.arange(6), dh), j_rope(np.arange(4), dh)
    jx, jc = jm.apply(variables, x, c, mask, rope, c_rope)
    t_rope = rope_cos_sin(torch.arange(6), dh)
    t_crope = rope_cos_sin(torch.arange(4), dh)
    with torch.no_grad():
        xo, co = tm(_t(x), _t(c), _t(mask), t_rope, t_crope)
        x2 = x.copy()
        x2[0, 5] = 7.0
        xo2, co2 = tm(_t(x2), _t(c), _t(mask), t_rope, t_crope)
    np.testing.assert_allclose(xo.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(co.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(xo[0, 4:].numpy(), 0.0)
    assert xo[1].abs().min() > 0
    np.testing.assert_allclose(xo[0, :4].numpy(), xo2[0, :4].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(co.numpy(), co2.numpy(), atol=1e-6)


def test_joint_attention_without_rope_or_mask_equals_jax():
    jm, variables, tm, x, c, _, _ = _joint(seed=3)
    jx, jc = jm.apply(variables, x, c)
    with torch.no_grad():
        xo, co = tm(_t(x), _t(c))
    np.testing.assert_allclose(xo.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(co.numpy(), np.asarray(jc), **TOL)


def test_joint_attention_context_pre_only():
    """No ``to_out_c``: the context output is None, as in JAX, and the
    sample stream still equals JAX's."""
    jm, variables, tm, x, c, _, _ = _joint(context_pre_only=True, dim=16,
                                           heads=2, seed=4)
    assert not any(k.startswith("to_out_c") for k in tm.state_dict())
    jx, jc = jm.apply(variables, x, c)
    with torch.no_grad():
        xo, co = tm(_t(x), _t(c))
    assert co is None and jc is None and xo.shape == x.shape
    np.testing.assert_allclose(xo.numpy(), np.asarray(jx), **TOL)
