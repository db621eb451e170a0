"""Latent attention (K8): the CUDA kernel and its plain version.

K8 :func:`latent_attention` computes the Moonlight stack's multi-head
latent attention in the absorbed form (``models/lm/moonlight.py
LatentAttention.absorbed``) between its first and last products: the
absorbed queries ``q`` (B, S, H, C) = [q_nope W_uk, q_pe], C = rank +
rope, attend over the latent rows where they lie, and each query row
returns softmax(scale q . row) . row[:rank] (B, S, H, rank) in q's dtype.
No TPU kernel: the JAX package has no latent attention.

Where the keys lie: with ``tables`` (B, MB) int32, ``rows`` is a latent
pool's layer (NB, BS, C) and key t of batch row b is row ``t % BS`` of
block ``tables[b, t // BS]`` (the serving decode step, any allocator's
tables); without, ``rows`` is a dense cache's layer (B, T, C) and key t is
``rows[b, t]``. ``pos0`` (B,) int32: query s of batch row b sits at
position ``pos0[b] + s`` and sees the keys t <= that position that the
table or cache holds (the causal mask of ``cached_forward`` and the
per-row mask of ``decode_step_multi``); ``pos0[b] < 0`` (an inactive slot)
returns zeros.

The kernel is CUDA C++ for sm_90a in ``csrc/latent_attention.cu``, built
with ``nvcc`` on first use (``ops/cuda/build.py``); it takes bf16 queries
and rows at the widths of :data:`WIDTHS` and raises on any other. The
wrapper launches it for CUDA tensors and takes the plain version beside it
only for tensors on the CPU: no fallback. It counts its launches in
``latent_attention.launches`` and the program counters ``lm.mla.calls``
(every call) and ``lm.mla.kernel`` (the calls through K8).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...utils.profiling import count, launched
from .paged_attention import NEG_INF

# (heads, rank + rope, rank) the kernel is built for: Moonlight-16B-A3B's
# and the tests' tiny stack's
WIDTHS = ((16, 576, 512), (4, 48, 32))
SPLIT_KEYS = 128  # keys a decode block covers, at least
MAX_SPLITS = 64  # decode blocks a batch row, at most


def latent_attention_ref(q, rows, pos0, rank: int, scale: float,
                         tables=None):
    """Plain K8 in the rounding order of the absorbed form: logits in fp32
    after the q . row product in the inputs' dtype, the additive mask, the
    softmax in fp32, the probabilities cast back to q's dtype before the
    p . v product over the rows' first ``rank`` columns."""
    b, s, _, _ = q.shape
    if tables is not None:
        bs = rows.shape[1]
        gather = (tables.long()[:, :, None] * bs + torch.arange(
            bs, device=rows.device)).reshape(b, -1)
        rows = rows.reshape(-1, rows.shape[-1])[gather]  # (B, MB * BS, C)
    key_pos = torch.arange(rows.shape[1], device=q.device)
    q_pos = pos0.long()[:, None] + torch.arange(s, device=q.device)
    mask = torch.where(key_pos <= q_pos[..., None], 0.0, NEG_INF)[:, None]
    logits = torch.einsum("bshc,btc->bhst", q, rows).float() * scale
    probs = torch.softmax(logits + mask, dim=-1).to(rows.dtype)
    out = torch.einsum("bhst,btr->bshr", probs, rows[..., :rank])
    return torch.where(pos0[:, None, None, None] >= 0, out,
                       torch.zeros_like(out))


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _library():
    from .build import load_library

    lib = load_library("latent_attention.cu")
    if not getattr(lib, "_typed", False):
        lib.latent_attention_bf16.argtypes = [_PTR] * 7 + [_INT] * 10 + [
            _FLOAT, _PTR]
        lib.latent_attention_bf16.restype = ctypes.c_int
        lib._typed = True
    return lib


def _require(cond: bool, what: str):
    if not cond:
        raise ValueError(f"latent attention kernel: {what}")


def split_plan(kmax: int) -> tuple:
    """-> (blocks a decode query's keys split over, keys a block): 128
    keys a block up to :data:`MAX_SPLITS` blocks, past that the least
    multiple of 128 that keeps them there. Fixed by the table's (or
    cache's) length, never by the positions, so a captured step replays."""
    width = SPLIT_KEYS * -(-kmax // (SPLIT_KEYS * MAX_SPLITS))
    return -(-kmax // width), width


def check_args(q, rows, pos0, rank: int, tables=None) -> int:
    """The checks of a kernel call -> the keys a batch row holds (kmax).
    Widths other than :data:`WIDTHS` raise, as do dtypes other than bf16,
    mixed devices, non-contiguous or misaligned tensors."""
    dev = q.device
    _require(q.dim() == 4, f"q must be (B, S, H, C), got {tuple(q.shape)}")
    b, _, h, c = q.shape
    _require((h, c, rank) in WIDTHS,
             f"(heads, width, rank) {(h, c, rank)} not in {WIDTHS}")
    _require(q.dtype == torch.bfloat16 and rows.dtype == torch.bfloat16,
             f"q and rows must be bf16, got {q.dtype} / {rows.dtype}")
    _require(rows.dim() == 3 and rows.shape[2] == c,
             f"rows must be (NB, BS, {c}) or (B, T, {c}), got "
             f"{tuple(rows.shape)}")
    _require(pos0.dtype == torch.int32 and tuple(pos0.shape) == (b,),
             f"pos0 must be int32 ({b},), got {pos0.dtype} "
             f"{tuple(pos0.shape)}")
    named = [("q", q), ("rows", rows), ("pos0", pos0)]
    if tables is None:
        _require(rows.shape[0] == b, f"a dense cache of {rows.shape[0]} "
                 f"rows for a batch of {b}")
        kmax = rows.shape[1]
    else:
        bs = rows.shape[1]
        _require(bs % 32 == 0, f"block size {bs} not a multiple of 32")
        _require(tables.dtype == torch.int32 and tables.dim() == 2
                 and tables.shape[0] == b,
                 f"tables must be int32 ({b}, MB), got {tables.dtype} "
                 f"{tuple(tables.shape)}")
        named.append(("tables", tables))
        kmax = tables.shape[1] * bs
    for name, t in named:
        _require(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in (("q", q), ("rows", rows)):
        # the kernel copies rows in 16-byte words
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    return kmax


def latent_attention(q, rows, pos0, rank: int, scale: float, tables=None):
    """K8 (module docstring) -> (B, S, H, rank) in q's dtype. A query
    length of 1 runs the decode's shape (a slot's keys split over blocks of
    :func:`split_plan`, then merged), a longer one the prefill's (4
    positions x the heads a block). Any number of keys a row."""
    count("lm.mla.calls")
    if q.device.type == "cpu":
        return latent_attention_ref(q, rows, pos0, rank, scale, tables)
    _require(q.device.type == "cuda",
             f"tensors must be on a CUDA device, got {q.device}")
    kmax = check_args(q, rows, pos0, rank, tables)
    b, s, h, c = q.shape
    splits, split_keys = split_plan(kmax) if s == 1 else (1, kmax)
    out = q.new_empty((b, s, h, rank))
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b, splits, h, rank), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, splits, h, 2), dtype=torch.float32,
                              device=q.device)
    rc = _library().latent_attention_bf16(
        q.data_ptr(), rows.data_ptr(),
        None if tables is None else tables.data_ptr(), pos0.data_ptr(),
        out.data_ptr(), None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), b, s, h, c, rank,
        0 if tables is None else tables.shape[1], rows.shape[1], kmax,
        splits, split_keys, scale * math.log2(math.e),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"latent_attention: CUDA launch failed with "
                           f"error {rc}")
    launched(latent_attention)
    count("lm.mla.kernel")
    return out


latent_attention.launches = 0
