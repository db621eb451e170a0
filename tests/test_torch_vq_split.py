"""The cluster-split VQ search's plan on the CPU: ``split_search`` computes
K5/K6 as the kernel in ``csrc/vq.cu`` does, in fp32:

* rows in tiles of R (16 or 32, ``vq.plan``'s pick); the codebook in
  ``vq.CLUSTER`` contiguous chunks of ceil(N / C) codes, one per CTA of a
  cluster (a chunk past N is empty and offers no candidate);
* per chunk, |e|^2 and each row's partial argmin, the first of equal
  minima;
* the C candidates of a row merged rank by rank, lower code first on equal
  distance; a row with no candidate (every distance NaN) takes code 0;
* per layer, the residual minus the chosen codebook row (a gather);
* the bytes the kernel reads and writes, counted as it reads them.

The mirror is held exactly to the port's plain versions and to the JAX
package (``ops/quant.py nearest_code``, the Pallas K5/K6 in interpret mode)
for each R the wrapper can pick, with ragged M and whole tiles, N not a multiple of C, N < C, exact ties
placed across chunk boundaries (integer-valued data, so that every sum is
exact in any order) and rows of NaN. The CUDA kernel is held against
the plain versions on the card in tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unified_audio_tpu.ops import quant as j_quant
from unified_audio_tpu.ops.pallas import vq_kernel
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.ops.cuda import vq

NO_CODE = 2 ** 31 - 1  # an empty chunk's candidate code (INT_MAX)


def split_search(x, books, rows, cluster=vq.CLUSTER, counted=None):
    """codes (M, nq) int32 of x (M, D) over the nq (N, D) ``books``, by the
    kernel's plan; ``counted["bytes"]`` gains the bytes it reads and
    writes."""
    m, d = x.shape
    n = books[0].shape[0]
    chunk = -(-n // cluster)
    nbytes = 0
    codes = torch.empty(m, len(books), dtype=torch.int32)
    for r0 in range(0, m, rows):
        res = x[r0:r0 + rows].float().clone()
        nbytes += cluster * res.numel() * 4  # every CTA reads the rows
        for li, cb in enumerate(books):
            cb = cb.float()
            best_d = torch.full((len(res),), float("inf"))
            best_i = torch.full((len(res),), NO_CODE, dtype=torch.int64)
            for q in range(cluster):  # the merge, rank by rank
                c0, c1 = min(n, q * chunk), min(n, q * chunk + chunk)
                if c0 == c1:
                    continue  # (inf, NO_CODE) never wins
                part = cb[c0:c1]
                nbytes += part.numel() * 4
                dist = part.square().sum(-1) - 2.0 * (res @ part.T)
                d2, i2 = dist.min(-1).values, dist.argmin(-1) + c0
                take = (d2 < best_d) | ((d2 == best_d) & (i2 < best_i))
                best_d = torch.where(take, d2, best_d)
                best_i = torch.where(take, i2, best_i)
            best_i = torch.where(best_i == NO_CODE, 0, best_i)
            codes[r0:r0 + rows, li] = best_i.int()
            nbytes += len(res) * 4  # rank 0 writes the codes
            if li + 1 < len(books):
                res = res - cb[best_i]
                nbytes += cluster * res.numel() * 4  # each CTA's gather
    if counted is not None:
        counted["bytes"] = counted.get("bytes", 0) + nbytes
    return codes


def _normal(seed, m, n, d, nq):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((nq, n, d)).astype(np.float32))


def _pallas(x, cbs):
    """The TPU kernels in interpret mode: K5 for one codebook, K6 else."""
    if len(cbs) == 1:
        return np.asarray(vq_kernel.nearest_code_pallas(
            jnp.asarray(x), jnp.asarray(cbs[0]), interpret=True))[:, None]
    return np.asarray(vq_kernel.rvq_encode_fused_pallas(
        jnp.asarray(x), jnp.asarray(cbs), interpret=True))


def _hold(x, cbs, rows):
    """The mirror == the plain version == JAX (Pallas interpret and, for
    one codebook, ``ops/quant.py nearest_code``) -> the codes."""
    tx, tcbs = torch.as_tensor(x), torch.as_tensor(cbs)
    got = split_search(tx, list(tcbs), rows).numpy()
    np.testing.assert_array_equal(got, vq.rvq_encode_fused_ref(tx, tcbs))
    np.testing.assert_array_equal(got, _pallas(x, cbs))
    if len(cbs) == 1:
        np.testing.assert_array_equal(got[:, 0], np.asarray(
            j_quant.nearest_code(jnp.asarray(x), jnp.asarray(cbs[0]))))
    return got


@pytest.mark.parametrize("rows", vq.ROWS)
@pytest.mark.parametrize("m,n,d", [
    (37, 300, 32),   # ragged M, N = 8 chunks of 38 less 4
    (70, 1024, 16),  # HCodec's N, D below a stage
    (50, 61, 48),    # N not a multiple of C, D not of 32
    (33, 5, 16),     # N < C: three empty chunks
    (32, 1024, 16),  # one whole tile of rows
    (65, 64, 32),    # two whole tiles and one row
    (1, 7, 16),      # one row, N < C
])
def test_split_k5_matches_plain_and_jax(rows, m, n, d):
    x, cbs = _normal(m + n, m, n, d, 1)
    _hold(x, cbs, rows)


@pytest.mark.parametrize("rows", vq.ROWS)
@pytest.mark.parametrize("m,n,d", [(37, 300, 32), (20, 9, 16),
                                   (64, 1024, 16), (97, 61, 32)])
def test_split_k6_matches_plain_and_jax(rows, m, n, d):
    x, cbs = _normal(m + n + 1, m, n, d, 4)
    _hold(x, cbs, rows)


@pytest.mark.parametrize("rows", vq.ROWS)
@pytest.mark.parametrize("at", ["head", "tail"])
@pytest.mark.parametrize("nq", [1, 4])
def test_exact_ties_across_chunks_go_to_the_lower_code(nq, at, rows):
    """Equal codebook rows on either side of a chunk boundary (7|8, 23|24)
    and in chunks far apart (10 and 60), N = 64 in chunks of 8; rows equal
    to them, at the head of the first tile of rows or at the tail of a
    ragged last one: the lower code wins, in the mirror as in the plain
    version and the JAX kernels. Integer values keep every distance
    exact."""
    rng = np.random.default_rng(5)
    cbs = rng.integers(-2, 3, (nq, 64, 16)).astype(np.float32)
    for lo, hi in ((7, 8), (23, 24), (10, 60)):
        cbs[:, hi] = cbs[:, lo]
    tied = cbs[0, [8, 24, 60, 7]]
    rest = rng.integers(-2, 3, (rows + 3, 16)).astype(np.float32)
    x = np.concatenate([tied, rest] if at == "head" else [rest, tied])
    got = _hold(x, cbs, rows)
    rows = slice(0, 4) if at == "head" else slice(-4, None)
    np.testing.assert_array_equal(got[rows, 0], [7, 23, 10, 7])


@pytest.mark.parametrize("rows", vq.ROWS)
@pytest.mark.parametrize("where", ["first", "tile_end", "all"])
@pytest.mark.parametrize("nq", [1, 4])
def test_nan_rows_take_code_zero(nq, where, rows):
    """A row of x that holds a NaN has every distance NaN: no chunk offers
    a candidate, and the row takes code 0 in every layer, as the plain
    argmin and the JAX kernels give; the other rows keep their codes."""
    x, cbs = _normal(nq + 7, 70, 300, 32, nq)
    nan = {"first": [0], "tile_end": [rows - 1, 69],
           "all": list(range(70))}[where]
    x[nan, 3] = np.nan
    got = _hold(x, cbs, rows)
    assert (got[nan] == 0).all()
    if where != "all":
        keep = np.setdiff1d(np.arange(70), nan)
        np.testing.assert_array_equal(
            got[keep], split_search(torch.as_tensor(x[keep]),
                                    list(torch.as_tensor(cbs)), rows).numpy())


@pytest.mark.parametrize("m,n,d,nq,rows", [(250, 1024, 512, 1, 32),
                                           (250, 1024, 512, 4, 32),
                                           (240, 1024, 512, 4, 16),
                                           (300, 61, 32, 4, 16)])
def test_l2_bytes_counts_what_the_plan_reads(m, n, d, nq, rows):
    """``vq.l2_bytes`` == the bytes the mirror reads and writes (at one
    10-s clip: 20.9 MB for K5, 83.5 MB for K6)."""
    counted = {}
    x = torch.zeros(m, d)
    split_search(x, [torch.zeros(n, d)] * nq, rows, counted=counted)
    assert vq.l2_bytes(m, n, d, nq, rows) == counted["bytes"]


@pytest.mark.parametrize("m,active,rows", [
    (250, 15, 32),   # one 10-s clip: 16 clusters of 16 would not fit
    (240, 15, 16),   # 15 clusters of 16
    (100, 15, 16),   # a 4-s clip: 7 clusters of 16
    (2000, 15, 32),  # eight clips: 63 clusters of 32, five waves
    (250, 30, 16),   # two CTAs an SM (a small D): 16 clusters fit
])
def test_plan_picks_rows(m, active, rows):
    assert vq.plan(m, active) == rows


def test_residual_vq_reads_its_buffers_and_follows_a_reload():
    """``ResidualVQ.codebooks()`` are views of the layers' buffers (no
    copy per encode), and codes follow a ``load_state_dict``."""
    port = t_quant.ResidualVQ(16, 32, 4)
    x, cbs = _normal(9, 40, 32, 16, 4)
    y, cbs2 = _normal(10, 1, 32, 16, 4)
    port.load_state_dict({f"layers.{i}._codebook.embed":
                          torch.as_tensor(cbs[i])[None] for i in range(4)})
    books = port.codebooks()
    assert all(b.data_ptr() == layer._codebook.embed.data_ptr()
               for b, layer in zip(books, port.layers))
    tx = torch.as_tensor(x)
    before = port.encode(tx)
    np.testing.assert_array_equal(
        before, vq.rvq_encode_fused_ref(tx, torch.as_tensor(cbs)))
    port.load_state_dict({f"layers.{i}._codebook.embed":
                          torch.as_tensor(cbs2[i])[None] for i in range(4)})
    after = port.encode(tx)
    np.testing.assert_array_equal(
        after, vq.rvq_encode_fused_ref(tx, torch.as_tensor(cbs2)))
    assert not torch.equal(before, after)
