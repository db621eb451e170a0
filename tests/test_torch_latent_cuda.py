"""K8, the latent-attention kernel (``ops/cuda/latent_attention.py``), on
the card against its plain version, at Moonlight's widths (16 heads over
576-wide rows, rank 512) and the tiny stack's (4 heads, 48, 32), bf16:

* the decode shape over a latent pool, in the owner mode (each slot's
  table one contiguous region) and a paged mode (tables of scattered
  blocks), at indices from 0 to the table's end and past it, inactive
  slots (-1) on trash tables returning zeros;
* the prefill shape over a dense cache, causal from position 0 at a
  length that is a multiple of 64 and one that is not, and from a later
  position (a chunk after a prefix); the decode shape over a dense cache
  (per-row positions, as ``decode_step_multi`` runs it);
* rows of more keys than 64 decode blocks of 128 hold (9,000 and 9,600,
  as the offline generate's dense cache reaches past ~80 s of audio): the
  decode's blocks widen, the prefill takes them as any other;
* the wrapper's refusals on the card, with no launch counted.

Tolerance: both versions round at the same points (the inputs, the
probabilities before p.v, the output) but the plain one also rounds its
logits to bf16, so each is held to the fp32 computation over the same
bf16 inputs: K8's error at most the plain version's plus 2e-3 of the
output's scale. Needs a CUDA card; imports no JAX:

    python -m pytest tests/test_torch_latent_cuda.py --noconftest -q
"""
import pytest
import torch

from unified_audio_tpu_torch.ops.cuda import latent_attention as la

SHAPES = {"moonlight": (16, 576, 512), "tiny": (4, 48, 32)}
BS = 64  # the serving pool's block size


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scale(c, rank):
    return (c - rank + 128) ** -0.5  # (nope + rope)^-0.5 at nope 128


def _held(q, rows, pos0, rank, tables=None):
    """K8 against the plain version, both against fp32 over the same bf16
    inputs -> (K8's error, the plain version's error, the output's
    scale)."""
    scale = _scale(q.shape[-1], rank)
    got = la.latent_attention(q, rows, pos0, rank, scale, tables)
    plain = la.latent_attention_ref(q, rows, pos0, rank, scale, tables)
    exact = la.latent_attention_ref(q.float(), rows.float(), pos0, rank,
                                    scale, tables)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == plain.shape
    dead = pos0 < 0
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    err = (got.float() - exact).abs().max().item()
    plain_err = (plain.float() - exact).abs().max().item()
    return err, plain_err, exact.abs().max().item()


def _ok(err, plain_err, top):
    assert err <= plain_err + 2e-3 * top, (err, plain_err, top)


def _pool(card, nb, c, gen):
    return torch.randn((nb, BS, c), generator=gen, device=card).bfloat16()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("mode", ["owner", "paged"])
def test_decode_over_pool(card, name, mode):
    h, c, rank = SHAPES[name]
    gen = torch.Generator(device=card).manual_seed(1)
    slots, mb = 64, 14
    nb = 1 + slots * mb
    pool = _pool(card, nb, c, gen)
    if mode == "owner":
        tables = 1 + torch.arange(slots * mb, device=card).view(slots, mb)
    else:
        tables = 1 + torch.randperm(slots * mb, generator=gen,
                                    device=card).view(slots, mb)
    kmax = mb * BS
    # every edge: 0, a block's last and next row, a split's, the table's
    # last row and past it; the rest drawn; inactive slots on trash tables
    edges = [0, 1, 31, 32, 63, 64, 127, 128, 129, kmax - 1, kmax, kmax + 5]
    pos = torch.randint(0, kmax, (slots,), generator=gen, device=card)
    pos[:len(edges)] = torch.tensor(edges, device=card)
    pos[-4:] = -1
    tables[-4:] = 0
    q = torch.randn((slots, 1, h, c), generator=gen, device=card).bfloat16()
    _ok(*_held(q, pool, pos.int(), rank, tables.int()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("length", [128, 77])
def test_prefill_over_dense_cache(card, name, length):
    h, c, rank = SHAPES[name]
    gen = torch.Generator(device=card).manual_seed(2)
    b = 5
    cache = torch.randn((b, length, c), generator=gen, device=card).bfloat16()
    q = torch.randn((b, length, h, c), generator=gen,
                    device=card).bfloat16()
    pos0 = torch.zeros((b,), dtype=torch.int32, device=card)
    _ok(*_held(q, cache, pos0, rank))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_chunk_and_rows_over_dense_cache(card, name):
    """A chunk of 6 positions after a prefix of 40 (prefill shape), then
    one position a row at per-row depths, one row inactive (decode
    shape)."""
    h, c, rank = SHAPES[name]
    gen = torch.Generator(device=card).manual_seed(3)
    b, t = 4, 300
    cache = torch.randn((b, t, c), generator=gen, device=card).bfloat16()
    q = torch.randn((b, 6, h, c), generator=gen, device=card).bfloat16()
    pos0 = torch.full((b,), 40, dtype=torch.int32, device=card)
    _ok(*_held(q, cache, pos0, rank))
    q1 = q[:, :1].contiguous()
    rows = torch.tensor([0, 129, t - 1, -1], dtype=torch.int32, device=card)
    _ok(*_held(q1, cache, rows, rank))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_past_8192_keys(card, name):
    h, c, rank = SHAPES[name]
    gen = torch.Generator(device=card).manual_seed(4)
    b, t = 3, 9000
    assert la.split_plan(t)[1] > la.SPLIT_KEYS
    cache = torch.randn((b, t, c), generator=gen, device=card).bfloat16()
    q1 = torch.randn((b, 1, h, c), generator=gen, device=card).bfloat16()
    rows = torch.tensor([t - 1, 8192, 4000], dtype=torch.int32, device=card)
    _ok(*_held(q1, cache, rows, rank))  # decode over the dense cache
    q = torch.randn((b, 8, h, c), generator=gen, device=card).bfloat16()
    pos0 = torch.full((b,), t - 8, dtype=torch.int32, device=card)
    _ok(*_held(q, cache, pos0, rank))  # a chunk at its end
    mb = 150  # 9,600 keys through scattered tables
    pool = _pool(card, 1 + b * mb, c, gen)
    tables = 1 + torch.randperm(b * mb, generator=gen,
                                device=card).view(b, mb)
    pos = torch.tensor([mb * BS - 1, 8200, 300], dtype=torch.int32,
                       device=card)
    _ok(*_held(q1, pool, pos, rank, tables.int()))


@pytest.mark.requires_cuda
def test_refusals_count_no_launch(card):
    h, c, rank = SHAPES["moonlight"]
    q = torch.zeros((2, 1, h, c), device=card, dtype=torch.bfloat16)
    rows = torch.zeros((2, 64, c), device=card, dtype=torch.bfloat16)
    pos0 = torch.zeros((2,), dtype=torch.int32, device=card)
    before = la.latent_attention.launches
    bad = [(q[:, :, :8].contiguous(), rows, pos0, rank),  # 8 heads
           (q.float(), rows.float(), pos0, rank),  # fp32
           (q, rows, pos0, 256),  # rank 256 of 576
           (q, rows, pos0.long(), rank),  # int64 positions
           (q, rows[:1], pos0, rank),  # a cache of 1 row for 2
           (q, rows.cpu(), pos0, rank)]  # mixed devices
    for args in bad:
        with pytest.raises(ValueError):
            la.latent_attention(*args, 0.1)
    tables = torch.zeros((2, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):  # a block of 48 rows
        la.latent_attention(q, rows[:, :48].contiguous(), pos0, rank, 0.1,
                            tables)
    assert la.latent_attention.launches == before
