"""K8's wrapper and plain version on the CPU (``ops/cuda/latent_attention.py``):

* the argument checks a CUDA call makes: widths other than the two the
  kernel is built for, dtypes other than bf16, bad positions, tables or
  block sizes raise; the two widths pass, with the keys a row holds, at
  any number of keys; the decode's split of a row's keys over blocks
  (``split_plan``) covers them in at most 64 blocks of a multiple of 128;
* the plain version's definition: a pool through scattered tables gives a
  dense cache's result exactly, an inactive row (position -1) returns
  zeros, a position past the table sees every key, and the result is the
  softmax of the absorbed attention over the visible keys (fp32, against
  an explicit loop);
* the program counters: a CPU call counts ``lm.mla.calls`` and not
  ``lm.mla.kernel``; counts and kernel launches the holding thread makes
  under ``profiling.held`` reach the held dict, not the recorder or the
  wrapper, whether it is on or off, other threads' counts reach the
  recorder, and ``profiling.release`` makes a held dict n times over.
"""
import pytest
import torch

from unified_audio_tpu_torch.ops.cuda import latent_attention as la
from unified_audio_tpu_torch.utils import profiling

H, C, R = la.WIDTHS[1]  # the tiny stack's: 4 heads over 48, rank 32


def _args(b=2, s=1, h=H, c=C, t=64, dtype=torch.bfloat16):
    q = torch.zeros((b, s, h, c), dtype=dtype)
    rows = torch.zeros((b, t, c), dtype=dtype)
    return q, rows, torch.zeros((b,), dtype=torch.int32)


@pytest.mark.parametrize("h, c, rank", [(8, 576, 512), (16, 576, 256),
                                        (16, 512, 512), (4, 64, 32),
                                        (2, 48, 32)])
def test_widths_it_is_not_built_for_raise(h, c, rank):
    q, rows, pos0 = _args(h=h, c=c)
    with pytest.raises(ValueError, match="not in"):
        la.check_args(q, rows, pos0, rank)


@pytest.mark.parametrize("width", la.WIDTHS)
def test_built_widths_pass(width):
    h, c, rank = width
    q, rows, pos0 = _args(h=h, c=c, t=77)
    assert la.check_args(q, rows, pos0, rank) == 77
    pool = torch.zeros((9, 64, c), dtype=torch.bfloat16)
    tables = torch.zeros((2, 5), dtype=torch.int32)
    assert la.check_args(q, pool, pos0, rank, tables) == 5 * 64
    q, rows, pos0 = _args(h=h, c=c, t=64 * 129)  # past 64 splits of 128
    assert la.check_args(q, rows, pos0, rank) == 64 * 129


@pytest.mark.parametrize("kmax", [1, 128, 129, 896, 8192, 8193, 9000,
                                  100_000])
def test_split_plan_covers_the_keys(kmax):
    splits, width = la.split_plan(kmax)
    assert 1 <= splits <= la.MAX_SPLITS and width % la.SPLIT_KEYS == 0
    assert (splits - 1) * width < kmax <= splits * width
    assert width == la.SPLIT_KEYS or kmax > la.SPLIT_KEYS * la.MAX_SPLITS


def test_other_arguments_raise():
    q, rows, pos0 = _args()
    bad = [(q.float(), rows.float(), pos0, R, None),  # fp32
           (q[0], rows, pos0, R, None),  # q not 4-D
           (q, rows, pos0.long(), R, None),  # int64 positions
           (q, rows, pos0[:1], R, None),  # one position for two rows
           (q, rows[:1], pos0, R, None),  # a dense cache of one row
           (q, rows[..., :32].contiguous(), pos0, R, None),  # rows too narrow
           (q, rows.new_zeros((64, 2, C)).transpose(0, 1), pos0, R,
            None),  # not contiguous
           (q, rows[:, :48].contiguous(), pos0, R,  # block of 48 rows
            torch.zeros((2, 3), dtype=torch.int32)),
           (q, rows, pos0, R, torch.zeros((2, 3), dtype=torch.int64))]
    for q_, rows_, pos_, rank, tables in bad:
        with pytest.raises(ValueError):
            la.check_args(q_, rows_, pos_, rank, tables)


def _case(seed, b=3, s=1, t=192, bs=64):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, H, C), generator=g)
    dense = torch.randn((b, t, C), generator=g)
    nb = 1 + b * (t // bs)
    tables = 1 + torch.randperm(nb - 1, generator=g).view(b, t // bs).int()
    pool = torch.randn((nb, bs, C), generator=g)
    pool.view(-1, C)[(tables.long()[:, :, None] * bs + torch.arange(bs)
                      ).reshape(b, t)] = dense
    return q, dense, pool, tables


@pytest.mark.parametrize("pos", [[0, 63, 191], [64, 100, 250], [-1, 5, 128]])
def test_pool_through_tables_equals_dense_cache(pos):
    q, dense, pool, tables = _case(1)
    pos0 = torch.tensor(pos, dtype=torch.int32)
    want = la.latent_attention_ref(q, dense, pos0, R, 0.2)
    got = la.latent_attention_ref(q, pool, pos0, R, 0.2, tables)
    assert torch.equal(got, want)
    dead = pos0 < 0
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))


@pytest.mark.parametrize("s, p0", [(1, 37), (5, 0), (5, 100), (1, 400)])
def test_plain_is_softmax_over_visible_keys(s, p0):
    q, dense, _, _ = _case(2, s=s)
    pos0 = torch.full((3,), p0, dtype=torch.int32)
    # the plain version takes its logits to fp32 whatever its inputs: the
    # loop's fp64 result is met to fp32 rounding
    got = la.latent_attention_ref(q.double(), dense.double(), pos0, R, 0.2)
    t = dense.shape[1]
    for b in range(3):
        for i in range(s):
            last = min(p0 + i, t - 1)
            keys = dense[b, :last + 1].double()
            w = torch.softmax(0.2 * q[b, i].double() @ keys.T, dim=-1)
            torch.testing.assert_close(got[b, i], w @ keys[:, :R],
                                       rtol=1e-5, atol=1e-6)


def test_cpu_call_counts_calls_not_kernel():
    q, dense, _, _ = _case(3)
    pos0 = torch.tensor([3, 4, 5], dtype=torch.int32)
    profiling.reset()
    profiling.enable()
    try:
        la.latent_attention(q, dense, pos0, R, 0.2)
        la.latent_attention(q, dense, pos0, R, 0.2)
        counts = profiling.export()["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    assert counts.get("lm.mla.calls") == 2
    assert "lm.mla.kernel" not in counts


@pytest.mark.parametrize("on", [True, False])
def test_held_counts_skip_the_recorder(on):
    profiling.reset()
    if on:
        profiling.enable()
    try:
        with profiling.held() as got:
            profiling.count("lm.mla.calls", 3)
            profiling.count("lm.mla.calls")
        profiling.count("engine.graph_steps")
        counts = profiling.export()["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    assert got == {"lm.mla.calls": 4}
    assert counts == ({"engine.graph_steps": 1} if on else {})


def test_held_counts_only_the_holding_thread():
    import threading

    profiling.reset()
    profiling.enable()
    try:
        with profiling.held() as got:
            other = threading.Thread(
                target=profiling.count, args=("data.loader_cpu_s", 2))
            other.start()
            other.join()
            profiling.count("lm.mla.calls")
        counts = profiling.export()["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    assert got == {"lm.mla.calls": 1}
    assert counts == {"data.loader_cpu_s": 2}


@pytest.mark.parametrize("on", [True, False])
def test_release_makes_held_launches_and_counts_n_times_over(on):
    def wrapper():
        pass
    wrapper.launches = 5
    profiling.reset()
    if on:
        profiling.enable()
    try:
        with profiling.held() as got:
            profiling.launched(wrapper)
            profiling.launched(wrapper)
            profiling.count("lm.mla.calls", 2)
        assert wrapper.launches == 5
        assert profiling.export()["counts"] == {}
        profiling.release(got, 3)
        counts = profiling.export()["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    assert got == {wrapper: 2, "lm.mla.calls": 2}
    assert wrapper.launches == 5 + 6
    assert counts == ({"lm.mla.calls": 6} if on else {})
