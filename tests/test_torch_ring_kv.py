"""The port's ring-KV streaming transformer (``unified_audio_tpu_torch/nn/
streaming.py``) against the JAX package's, on the CPU, mirroring
``tests/test_streaming.py``: the offline forward within 1e-4 of JAX's; the
Mimi invariant (chunks of 1, 3 and 4 streamed through ``step`` equal the
offline sliding-window forward within 1e-4) with a ring larger than the
context and with a ring of exactly the context (slots overwritten); the
projected variant; the state's layout against ``init_ring_state``; the
state passed in left untouched; a chunk the ring cannot hold with its
context refused (capacity < context + chunk - 1)."""
import jax
import numpy as np
import pytest
import torch

from test_torch_common import TOL, random_variables, to_torch
from unified_audio_tpu.nn import streaming as j_st
from unified_audio_tpu_torch.nn import streaming as t_st
from unified_audio_tpu_torch.utils import convert as t_convert


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jm = j_st.StreamingTransformer(dim=32, num_layers=2, num_heads=4,
                                   context=4)
    variables = random_variables(jm, x, seed=1)
    tm = t_st.StreamingTransformer(32, num_layers=2, num_heads=4, context=4)
    tm.load_state_dict(to_torch(t_convert.streaming_state_dict(variables)))
    return jm, variables, tm.eval(), x


def _stream(tm, x, chunk, capacity=None):
    state = tm.init_state(x.shape[0], capacity)
    outs = []
    with torch.no_grad():
        for i in range(0, x.shape[1], chunk):
            y, state = tm.step(torch.as_tensor(x[:, i:i + chunk]), state)
            outs.append(y)
    return torch.cat(outs, dim=1).numpy(), state


def test_offline_equals_jax(setup):
    jm, variables, tm, x = setup
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(jm.apply(variables, x)), **TOL)


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_streaming_matches_offline(setup, chunk):
    """A 12-slot ring: the streamed output equals the offline one (and
    JAX's offline one), and ``end`` counts the frames."""
    jm, variables, tm, x = setup
    streamed, state = _stream(tm, x, chunk, capacity=12)
    with torch.no_grad():
        offline = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(streamed, offline, atol=1e-4, rtol=0)
    np.testing.assert_allclose(streamed, np.asarray(jm.apply(variables, x)),
                               **TOL)
    assert int(state["end"]) == 12


def test_streaming_equals_jax_step(setup):
    """Chunks of 3 through the port's and JAX's ``step``: outputs within
    1e-4, the rings' positions equal."""
    jm, variables, tm, x = setup
    streamed, state = _stream(tm, x, 3, capacity=8)
    jstate = jm.apply(variables, 2, 8, method="init_state")
    outs = []
    for i in range(0, 12, 3):
        y, jstate = jm.apply(variables, x[:, i:i + 3], jstate, method="step")
        outs.append(np.asarray(y))
    np.testing.assert_allclose(streamed, np.concatenate(outs, 1), **TOL)
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    np.testing.assert_allclose(state["k"].numpy(), np.asarray(jstate["k"]),
                               **TOL)


def test_ring_eviction(setup):
    """capacity == context: old keys are overwritten, the window still
    equals the offline sliding window."""
    _, _, tm, x = setup
    streamed, state = _stream(tm, x, 1, capacity=4)
    with torch.no_grad():
        offline = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(streamed, offline, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  [[8, 9, 10, 11]] * 2)


def test_state_layout_equals_jax(setup):
    _, _, tm, _ = setup
    want = j_st.init_ring_state(2, 3, 5, 4, 8)
    got = tm.init_state(3, 5)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_step_leaves_the_given_state(setup):
    _, _, tm, x = setup
    state = tm.init_state(2, 6)
    before = {k: v.clone() for k, v in state.items()}
    with torch.no_grad():
        tm.step(torch.as_tensor(x[:, :3]), state)
    for k, v in before.items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("chunk,capacity", [(5, 4), (2, 4), (3, 5)])
def test_chunk_that_does_not_fit_raises(setup, chunk, capacity):
    """A ring needs context + chunk - 1 slots: with fewer, the chunk's
    first queries would lose keys the chunk overwrites (JAX computes such
    a chunk to a result that differs from the offline forward)."""
    _, _, tm, x = setup
    with pytest.raises(ValueError, match="does not fit"):
        tm.step(torch.as_tensor(x[:, :chunk]), tm.init_state(2, capacity))


def test_tightest_ring_for_each_chunk(setup):
    """capacity = context + chunk - 1 is enough for every chunk size."""
    _, _, tm, x = setup
    with torch.no_grad():
        offline = tm(torch.as_tensor(x)).numpy()
    for chunk in (2, 3, 4):
        streamed, _ = _stream(tm, x, chunk, capacity=3 + chunk)
        np.testing.assert_allclose(streamed, offline, atol=1e-4, rtol=0)


def test_projected_streaming_equals_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 16)).astype(np.float32)
    jm = j_st.ProjectedStreamingTransformer(dim=32, input_dim=16,
                                            output_dim=24, num_layers=1,
                                            num_heads=4, context=4)
    variables = random_variables(jm, x, seed=3)
    tm = t_st.ProjectedStreamingTransformer(32, 16, 24, num_layers=1,
                                            num_heads=4, context=4)
    tm.load_state_dict(to_torch(t_convert.streaming_state_dict(variables)))
    with torch.no_grad():
        offline = tm(torch.as_tensor(x)).numpy()
    assert offline.shape == (1, 8, 24)
    np.testing.assert_allclose(offline, np.asarray(jm.apply(variables, x)),
                               **TOL)
    streamed, _ = _stream(tm, x, 1)
    np.testing.assert_allclose(streamed, offline, atol=1e-4, rtol=0)
