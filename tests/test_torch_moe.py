"""The port's routed-expert ``MoE`` and sliding-window ``Transformer``
(``unified_audio_tpu_torch/nn/transformer.py``) against the JAX package's,
on the CPU, mirroring ``tests/test_blocks.py TestTransformer``: the causal
transformer and its causality, the sliding-window mask and transformer,
the MoE transformer (3 experts top-1, 4 experts top-2), a standalone MoE
with the sigmoid gate and a route scale, the MoE's gradients, and exact
ties in the gate, where the lower expert index must win as in
``jax.lax.top_k``. Forward within 1e-4 of JAX; gradients within 1e-4 of
their largest entry (fp32 sums in two orders). The expert-parallel run is
``tests/test_torch_parallel_layers.py``'s "moe_ep" scenario."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables, to_torch
from unified_audio_tpu.nn import transformer as j_tr
from unified_audio_tpu_torch.nn import transformer as t_tr
from unified_audio_tpu_torch.utils import convert as t_convert


def _pair(seed=0, x_shape=(2, 12, 32), **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    jm = j_tr.Transformer(**kw)
    variables = random_variables(jm, x, seed=seed + 1)
    tm = t_tr.Transformer(**kw)
    tm.load_state_dict(to_torch(t_convert.transformer_state_dict(variables)))
    return jm, variables, tm, x


def _check(jm, variables, tm, x):
    want = np.asarray(jm.apply(variables, x))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    return got


def test_causal_transformer_equals_jax():
    """Causal: equal to JAX, and perturbing the future leaves the past."""
    jm, variables, tm, x = _pair(hidden_size=32, intermediate_size=64,
                                 num_heads=4, num_layers=2, causal=True)
    y1 = _check(jm, variables, tm, x)
    x2 = x.copy()
    x2[:, 8:] += 1.0
    with torch.no_grad():
        y2 = tm(torch.as_tensor(x2)).numpy()
    np.testing.assert_allclose(y1[:, :8], y2[:, :8], atol=1e-5)


@pytest.mark.parametrize("t,left", [(16, 4), (9, 1), (5, 8)])
def test_sliding_window_mask_equals_jax(t, left):
    np.testing.assert_array_equal(
        t_tr.sliding_window_mask(t, left).numpy(),
        np.asarray(j_tr.sliding_window_mask(t, left)))


def test_sliding_window_transformer_equals_jax():
    """``use_sliding_window`` with ``left_context`` 4: equal to JAX; equal
    to the plain causal transformer on the same weights over the first 4
    frames, where the window holds the whole past, and different after."""
    kw = dict(hidden_size=32, intermediate_size=64, num_heads=4,
              num_layers=1, causal=True)
    jm, variables, tm, x = _pair(x_shape=(1, 16, 32), use_sliding_window=True,
                                 left_context=4, **kw)
    windowed = _check(jm, variables, tm, x)
    plain = t_tr.Transformer(**kw)
    plain.load_state_dict(tm.state_dict())
    with torch.no_grad():
        full = plain(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(windowed[:, :4], full[:, :4], atol=1e-6)
    assert np.abs(windowed[:, 4:] - full[:, 4:]).min(axis=-1).max() > 1e-4


@pytest.mark.parametrize("experts,topk", [(3, 1), (4, 2)])
def test_moe_transformer_equals_jax(experts, topk):
    jm, variables, tm, x = _pair(seed=2, x_shape=(2, 6, 16), hidden_size=16,
                                 intermediate_size=32, num_heads=4,
                                 num_layers=2, use_moe=True,
                                 moe_experts=experts, moe_topk=topk)
    assert tm.layers[0].mlp.expert_w1.shape == (experts, 16, 32)
    _check(jm, variables, tm, x)


def _moe_pair(seed, **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    jm = j_tr.MoE(inter_dim=24, **kw)
    variables = random_variables(jm, x, seed=seed)
    tm = t_tr.MoE(16, 24, kw.get("n_routed_experts", 3),
                  kw.get("n_activated_experts", 1),
                  kw.get("n_shared_experts", 1), kw.get("route_scale", 1.0),
                  kw.get("score_func", "softmax"))
    tm.load_state_dict(to_torch(t_convert.moe_state_dict(variables)))
    return jm, variables, tm, x


@pytest.mark.parametrize("score_func", ["softmax", "sigmoid"])
def test_moe_equals_jax(score_func):
    jm, variables, tm, x = _moe_pair(3, n_routed_experts=5,
                                     n_activated_experts=2,
                                     n_shared_experts=2, route_scale=2.5,
                                     score_func=score_func)
    _check(jm, variables, tm, x)


def test_moe_gradients_equal_jax():
    """d mean(y^2) / d every parameter and d x, against ``jax.grad``."""
    jm, variables, tm, x = _moe_pair(4, n_routed_experts=4,
                                     n_activated_experts=2)

    def loss(v, xx):
        return jnp.mean(jnp.square(jm.apply(v, xx)))

    gv, gx = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    want = t_convert.moe_state_dict(jax.device_get(gv))
    xt = torch.as_tensor(x).requires_grad_(True)
    tm(xt).square().mean().backward()
    # the bias only picks the experts: no gradient reaches it (JAX: zeros)
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for k, p in tm.named_parameters()}
    assert tm.gate_bias.grad is None and not np.asarray(want["gate_bias"]).any()
    got["x"], want["x"] = xt.grad.numpy(), np.asarray(gx)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_ties_take_the_lower_index(topk):
    """A zero gate and a zero bias tie every expert: JAX's top-k takes the
    lowest indices, and so does the port (``torch.topk`` promises no
    order among equal values)."""
    jm, variables, tm, x = _moe_pair(5, n_routed_experts=4,
                                     n_activated_experts=topk)
    p = variables["params"]
    p["gate_linear"]["kernel"] = np.zeros_like(p["gate_linear"]["kernel"])
    p["gate_bias"] = np.zeros_like(p["gate_bias"])
    tm.load_state_dict(to_torch(t_convert.moe_state_dict(variables)))
    with torch.no_grad():
        combine = tm.combine_weights(torch.as_tensor(x)).numpy()
    want = np.zeros(4, np.float32)
    want[:topk] = 0.25
    np.testing.assert_allclose(combine, np.broadcast_to(want, combine.shape),
                               atol=1e-7)
    _check(jm, variables, tm, x)


@pytest.mark.parametrize("scores,k,want", [
    ([1.0, 3.0, 3.0, 2.0], 2, [1, 2]),
    ([0.5, 0.5, 0.5], 2, [0, 1]),
    ([2.0, 1.0, 2.0, 2.0], 3, [0, 2, 3]),
])
def test_top_k_indices_equal_jax_on_ties(scores, k, want):
    s = np.asarray(scores, np.float32)
    got = t_tr.top_k_indices(torch.as_tensor(s), k).tolist()
    assert got == want == np.asarray(jax.lax.top_k(s, k)[1]).tolist()
