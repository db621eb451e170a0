"""Paged flash-decode attention: CUDA kernels and plain versions.

Port of ``unified_audio_tpu/ops/pallas/paged_attention.py``:

* K1 :func:`paged_flash_decode_owner` (TPU kernel ``_owner_kernel_flat``),
  bf16 or fp32 pool;
* K2 :func:`paged_flash_decode_owner_q8` (``_owner_kernel_flat_q8``), int8
  pool with fp32 per-token scales;
* K3 :func:`paged_flash_decode_stream_flat` (``_stream_kernel_flat``), bf16
  or fp32 pool;
* K4 :func:`paged_flash_decode_stream_flat_q8` (``_stream_kernel_flat_q8``),
  int8 pool;
* K7 :func:`paged_flash_decode` (``_kernel``, the block-table decode), bf16
  or fp32 pool. No serving mode routes through it (none does in the JAX
  package either); it is held against its plain version and against K1/K3
  on live engine pools.

The kernels are CUDA C++ for sm_90a in ``csrc/paged_attention.cu``, built
with ``nvcc`` on first use (``ops/cuda/build.py``). Each wrapper launches its
kernel for CUDA tensors and uses the plain PyTorch version beside it only for
tensors on the CPU; there is no fallback from a failed launch. Each wrapper
counts its launches in a plain integer attribute, ``<wrapper>.launches``
(through ``utils/profiling.py launched``, which a captured CUDA graph's
step holds back for its replays).

Owner semantics (K1/K2): q (S, H, hd); pools flat (L, NB, BS, H*hd);
``start_block`` (S,) int32, the first physical block of each slot's
contiguous region; ``index`` (S,) int32, the last visible slot-local
position, -1 for an inactive slot (its output is zeros); ``li`` the layer.
Slot s's position p sits in block ``start_block[s] + p // BS`` at offset
``p % BS``. The result is softmax(q . K / sqrt(hd)) V over positions
``0..index[s]`` in fp32, returned in q's dtype.

Stream semantics (K3/K4): every slot attends to the keys of the pool prefix
``[0, nb * BS)`` (``nb`` = ``num_active_blocks``, the bound, at most the
pool's blocks) that its row of ``vis`` (S, nb * BS) int8 marks visible
(``serve/paged.py visibility_mask``). q, k and v are up-cast to fp32, the
probabilities stay fp32 for the p.v product, and the output is cast to q's
dtype at the end. A row with no visible key (an inactive slot, a table of
trash only) returns zeros.

Table semantics (K7): q (S, H, hd); pools (L, NB, BS, H, hd) as the TPU
kernel takes them, or the port's flat (L, NB, BS, H*hd) pool, the same
bytes; ``tables`` (S, MB) int32; ``index`` (S,) int32; ``li`` the layer.
Slot s attends its logical positions ``0..index[s]``: position p is row
``p % BS`` of physical block ``tables[s, p // BS]``, for p < MB*BS only (an
index at or past MB*BS attends exactly the table's MB*BS positions, and
``tables[s, MB]`` is never read). It attends positions, not blocks: a table
that repeats a physical block attends its rows once per position, and
entries at or past ``ceil((index+1)/BS)`` (trash, stale) are never read.
So K7 equals K3 on the visibility of :func:`serve.paged.table_visibility`
(which dedups blocks and drops the trash block) only on tables an allocator
hands out, and equals K1 on ``RegionAllocator`` regions. Rounding as K3:
q, k and v up-cast to fp32, the logits scaled after the q.k sum, p and the
p.v product fp32, the output cast to q's dtype once. An inactive slot
(``index < 0``) returns zeros (the TPU kernel returns the mean of V over
every table entry, trash included).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils.profiling import launched

NEG_INF = -1e9  # the additive mask value of the plain attention paths


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the reference the kernels are held against)
# ---------------------------------------------------------------------------

def _owned_rows(pool, start_block, index, block_size):
    """(S, P) ids of each slot's own token rows inside a layer (block *
    BS + offset) for positions 0..max(index), and their (S, P) visibility."""
    nb = pool.shape[1]
    n_pos = max(int(index.max()) + 1, 1)
    n_blk = -(-n_pos // block_size)
    blocks = start_block.long()[:, None] + torch.arange(
        n_blk, device=pool.device)[None]
    # slots whose region is shorter than the longest live prefix read
    # clamped in-pool blocks; those positions are masked below
    blocks = blocks.clamp_(max=nb - 1)
    tok = (blocks[:, :, None] * block_size + torch.arange(
        block_size, device=pool.device)).reshape(len(index), -1)
    pos = torch.arange(n_blk * block_size, device=pool.device)
    visible = pos[None] <= index.long()[:, None]
    return tok, visible


def paged_flash_decode_owner_ref(q, kpool, vpool, start_block, index, li):
    """Plain K1, with the rounding order of the plain paged attention
    (``serve/paged.py`` mode ``""``): logits in fp32 after the q.k product in
    the inputs' dtype, softmax in fp32, probabilities cast back to q's dtype
    before the p.v product."""
    s_slots, h, hd = q.shape
    _, _, bs, _ = kpool.shape
    tok, visible = _owned_rows(kpool, start_block, index, bs)
    k = kpool[li].reshape(-1, h, hd)[tok]  # (S, P, H, hd)
    v = vpool[li].reshape(-1, h, hd)[tok]
    mask = torch.where(visible, 0.0, NEG_INF)[:, None]  # (S, 1, P)
    logits = torch.einsum("shd,sphd->shp", q, k).float()
    logits = logits * hd ** -0.5 + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("shp,sphd->shd", probs, v.to(probs.dtype))
    return torch.where(index[:, None, None] >= 0, out, torch.zeros_like(out))


def paged_flash_decode_owner_q8_ref(q, kpool, vpool, k_scale, v_scale,
                                    start_block, index, li):
    """Plain K2: the int8 rows dequantize by row, folding the k scale into
    the logits and the v scale into the probabilities (same order as the
    plain int8 path of ``serve/paged.py``). ``k_scale``/``v_scale`` are the
    layer's (NB, BS) scales."""
    s_slots, h, hd = q.shape
    _, _, bs, _ = kpool.shape
    tok, visible = _owned_rows(kpool, start_block, index, bs)
    k = kpool[li].reshape(-1, h, hd)[tok].float()
    v = vpool[li].reshape(-1, h, hd)[tok].float()
    ksc = k_scale.reshape(-1)[tok]  # (S, P)
    vsc = v_scale.reshape(-1)[tok]
    mask = torch.where(visible, 0.0, NEG_INF)[:, None]
    logits = torch.einsum("shd,sphd->shp", q.float(), k)
    logits = logits * (ksc * hd ** -0.5)[:, None] + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = probs * vsc[:, None].to(probs.dtype)
    out = torch.einsum("shp,sphd->shd", probs, v.to(probs.dtype))
    return torch.where(index[:, None, None] >= 0, out, torch.zeros_like(out))


def _stream_bound(q, kpool, vis, num_active_blocks):
    """The bound ``nb`` of a stream call, checked against the pool and the
    mask as the TPU kernel checks it."""
    nb_total, bs = kpool.shape[1], kpool.shape[2]
    nb = nb_total if num_active_blocks is None else int(num_active_blocks)
    if not 1 <= nb <= nb_total:
        raise ValueError(f"num_active_blocks {nb} outside the pool's "
                         f"[1, {nb_total}] blocks")
    if tuple(vis.shape) != (q.shape[0], nb * bs):
        raise ValueError(f"visibility shape {tuple(vis.shape)} != (slots, "
                         f"bound*block_size) ({q.shape[0]}, {nb * bs})")
    return nb


def _stream_attend(logits, vis, v, v_scale, dtype):
    """Masked softmax over the prefix keys in fp32, p.v in fp32 (p scaled by
    the int8 pool's ``v_scale`` first); rows without a visible key -> 0."""
    seen = vis != 0  # (S, P)
    probs = torch.softmax(logits.masked_fill(~seen[:, None], -torch.inf), -1)
    if v_scale is not None:
        probs = probs * v_scale
    out = torch.einsum("shp,phd->shd", probs, v)
    return torch.where(seen.any(1)[:, None, None], out, 0.0).to(dtype)


def paged_flash_decode_stream_flat_ref(q, kpool, vpool, vis, li,
                                       num_active_blocks=None):
    """Plain K3, in the kernel's rounding order: q, k and v in fp32, the
    probabilities fp32 for the p.v product, the output cast to q's dtype."""
    nb = _stream_bound(q, kpool, vis, num_active_blocks)
    s_slots, h, hd = q.shape
    k = kpool[li, :nb].reshape(-1, h, hd).float()  # (P, H, hd)
    v = vpool[li, :nb].reshape(-1, h, hd).float()
    logits = torch.einsum("shd,phd->shp", q.float(), k) * hd ** -0.5
    return _stream_attend(logits, vis, v, None, q.dtype)


def paged_flash_decode_stream_flat_q8_ref(q, kpool, vpool, k_scale, v_scale,
                                          vis, li, num_active_blocks=None):
    """Plain K4: the k scale folds into the logits after the q.k product and
    before the mask, the v scale into the probabilities before the p.v
    product (the softmax denominator sums the unscaled probabilities).
    ``k_scale``/``v_scale`` are the layer's (NB, BS) scales."""
    nb = _stream_bound(q, kpool, vis, num_active_blocks)
    s_slots, h, hd = q.shape
    k = kpool[li, :nb].reshape(-1, h, hd).float()
    v = vpool[li, :nb].reshape(-1, h, hd).float()
    ksc = k_scale[:nb].reshape(-1)  # (P,)
    vsc = v_scale[:nb].reshape(-1)
    logits = torch.einsum("shd,phd->shp", q.float(), k) * (ksc * hd ** -0.5)
    return _stream_attend(logits, vis, v, vsc, q.dtype)


def paged_flash_decode_ref(q, kpool, vpool, tables, index, li):
    """Plain K7, by its definition (not through a visibility mask): each
    slot's logical positions gathered through its table, positions past
    ``index`` or past the table masked, in the rounding order of K3."""
    s_slots, h, hd = q.shape
    bs, mb = kpool.shape[2], tables.shape[1]
    # the table entries any position reaches (never past the table)
    n_blk = min(max(-(-(int(index.max()) + 1) // bs), 1), mb)
    pos = torch.arange(n_blk * bs, device=q.device)
    tok = tables[:, :n_blk].long()[:, pos // bs] * bs + pos % bs  # (S, P)
    k = kpool[li].reshape(-1, h, hd)[tok].float()  # (S, P, H, hd)
    v = vpool[li].reshape(-1, h, hd)[tok].float()
    logits = torch.einsum("shd,sphd->shp", q.float(), k) * hd ** -0.5
    seen = pos[None] <= index.long()[:, None]  # (S, P)
    probs = torch.softmax(logits.masked_fill(~seen[:, None], -torch.inf), -1)
    out = torch.einsum("shp,sphd->shd", probs, v)
    return torch.where(index[:, None, None] >= 0, out, 0.0).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_K1_ARGS = [_PTR] * 6 + [_INT] * 5 + [_FLOAT, _PTR]
_K2_ARGS = [_PTR] * 8 + [_INT] * 5 + [_FLOAT, _PTR]
_K3_ARGS = [_PTR] * 5 + [_INT] * 6 + [_FLOAT, _PTR]
_K4_ARGS = [_PTR] * 7 + [_INT] * 6 + [_FLOAT, _PTR]
_K7_ARGS = [_PTR] * 6 + [_INT] * 6 + [_FLOAT, _PTR]


def typed(lib):
    """``lib`` (a build of ``csrc/paged_attention.cu``) with the argument
    types of its C entry points set."""
    if not getattr(lib, "_typed", False):
        for name, args in (("owner_decode_f32", _K1_ARGS),
                           ("owner_decode_bf16", _K1_ARGS),
                           ("owner_decode_q8_f32", _K2_ARGS),
                           ("owner_decode_q8_bf16", _K2_ARGS),
                           ("stream_decode_f32", _K3_ARGS),
                           ("stream_decode_bf16", _K3_ARGS),
                           ("stream_decode_q8_f32", _K4_ARGS),
                           ("stream_decode_q8_bf16", _K4_ARGS),
                           ("table_decode_f32", _K7_ARGS),
                           ("table_decode_bf16", _K7_ARGS)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _library():
    from .build import load_library

    return typed(load_library("paged_attention.cu"))


def _require(cond: bool, what: str):
    if not cond:
        raise ValueError(f"paged flash-decode kernel: {what}")


def _check_pools(q, kpool, vpool, li, pool_dtypes, **slot_ints):
    """The checks every kernel call shares: q (S, H, 64) and equal flat pools
    of ``pool_dtypes`` on one CUDA device, contiguous and 16-byte aligned;
    ``slot_ints`` are (S,) int32 per-slot arguments."""
    dev = q.device
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(q.dim() == 3, f"q must be (S, H, hd), got {tuple(q.shape)}")
    s_slots, h, hd = q.shape
    _require(hd == 64, f"head dim {hd} unsupported (kernel is built for 64)")
    _require(kpool.dim() == 4 and kpool.shape == vpool.shape,
             f"pools must be equal (L, NB, BS, H*hd), got "
             f"{tuple(kpool.shape)} / {tuple(vpool.shape)}")
    _require(kpool.shape[3] == h * hd,
             f"pool row width {kpool.shape[3]} != H*hd = {h * hd}")
    _require(0 <= int(li) < kpool.shape[0], f"layer {li} out of range")
    _require(kpool.dtype in pool_dtypes and vpool.dtype == kpool.dtype,
             f"pool dtype {kpool.dtype} not in {pool_dtypes}")
    for name, t in slot_ints.items():
        _require(t.dtype == torch.int32 and t.shape == (s_slots,),
                 f"{name} must be int32 ({s_slots},), got {t.dtype} "
                 f"{tuple(t.shape)}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool),
                    *slot_ints.items()):
        _require(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        # the kernel reads rows with 16-byte vector loads
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _check_scales(q, k_scale, v_scale, nb, bs):
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _require(t.dtype == torch.float32 and t.shape == (nb, bs),
                 f"{name} must be fp32 ({nb}, {bs}), got {t.dtype} "
                 f"{tuple(t.shape)}")
        _require(t.device == q.device and t.is_contiguous(),
                 f"{name} must be contiguous on {q.device}")


def _check_vis(q, kpool, vis, num_active_blocks):
    """-> the bound; the mask is int8 (S, nb*BS), contiguous, 16-byte
    aligned, and a block's mask bytes are whole 16-byte words."""
    nb = _stream_bound(q, kpool, vis, num_active_blocks)
    _require(kpool.shape[2] % 16 == 0,
             f"block size {kpool.shape[2]} not a multiple of 16")
    _require(vis.dtype == torch.int8 and vis.device == q.device
             and vis.is_contiguous() and vis.data_ptr() % 16 == 0,
             f"vis must be contiguous 16-byte aligned int8 on {q.device}, "
             f"got {vis.dtype} on {vis.device}")
    return nb


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def paged_flash_decode_owner(q, kpool, vpool, start_block, index, li):
    """K1: owner-mode flash decode over a bf16 (or fp32) pool; q's dtype
    must match the pool's. Returns (S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_flash_decode_owner_ref(q, kpool, vpool, start_block,
                                            index, li)
    _check_pools(q, kpool, vpool, li, (torch.bfloat16, torch.float32),
                 start_block=start_block, index=index)
    _require(q.dtype == kpool.dtype,
             f"q dtype {q.dtype} != pool dtype {kpool.dtype}")
    lib = _library()
    fn = lib.owner_decode_bf16 if q.dtype == torch.bfloat16 \
        else lib.owner_decode_f32
    s_slots, h, hd = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            start_block.data_ptr(), index.data_ptr(), out.data_ptr(),
            s_slots, h, kpool.shape[1], kpool.shape[2], int(li),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_flash_decode_owner")
    launched(paged_flash_decode_owner)
    return out


def paged_flash_decode_owner_q8(q, kpool, vpool, k_scale, v_scale,
                                start_block, index, li):
    """K2: owner-mode flash decode over an int8 pool; ``k_scale``/
    ``v_scale`` are the layer's (NB, BS) fp32 scales. q is bf16 or fp32.
    Returns (S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_flash_decode_owner_q8_ref(q, kpool, vpool, k_scale,
                                               v_scale, start_block, index,
                                               li)
    _check_pools(q, kpool, vpool, li, (torch.int8,),
                 start_block=start_block, index=index)
    _require(q.dtype in (torch.bfloat16, torch.float32),
             f"q dtype {q.dtype} not bf16/fp32")
    nb, bs = kpool.shape[1], kpool.shape[2]
    _check_scales(q, k_scale, v_scale, nb, bs)
    lib = _library()
    fn = lib.owner_decode_q8_bf16 if q.dtype == torch.bfloat16 \
        else lib.owner_decode_q8_f32
    s_slots, h, hd = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), start_block.data_ptr(),
            index.data_ptr(), out.data_ptr(), s_slots, h, nb, bs, int(li),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_flash_decode_owner_q8")
    launched(paged_flash_decode_owner_q8)
    return out


def paged_flash_decode_stream_flat(q, kpool, vpool, vis, li,
                                   num_active_blocks=None):
    """K3: stream-mode flash decode over a bf16 (or fp32) pool: each slot
    against the visible keys of the prefix ``[0, num_active_blocks)``
    (default the whole pool); ``vis`` (S, nb*BS) int8. q's dtype must match
    the pool's. Returns (S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_flash_decode_stream_flat_ref(q, kpool, vpool, vis, li,
                                                  num_active_blocks)
    _check_pools(q, kpool, vpool, li, (torch.bfloat16, torch.float32))
    _require(q.dtype == kpool.dtype,
             f"q dtype {q.dtype} != pool dtype {kpool.dtype}")
    nb = _check_vis(q, kpool, vis, num_active_blocks)
    lib = _library()
    fn = lib.stream_decode_bf16 if q.dtype == torch.bfloat16 \
        else lib.stream_decode_f32
    s_slots, h, hd = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), vis.data_ptr(),
            out.data_ptr(), s_slots, h, kpool.shape[1], kpool.shape[2], nb,
            int(li), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_flash_decode_stream_flat")
    launched(paged_flash_decode_stream_flat)
    return out


def paged_flash_decode_stream_flat_q8(q, kpool, vpool, k_scale, v_scale, vis,
                                      li, num_active_blocks=None):
    """K4: K3 over an int8 pool; ``k_scale``/``v_scale`` are the layer's
    (NB, BS) fp32 scales. q is bf16 or fp32. Returns (S, H, hd) in q's
    dtype."""
    if q.device.type == "cpu":
        return paged_flash_decode_stream_flat_q8_ref(
            q, kpool, vpool, k_scale, v_scale, vis, li, num_active_blocks)
    _check_pools(q, kpool, vpool, li, (torch.int8,))
    _require(q.dtype in (torch.bfloat16, torch.float32),
             f"q dtype {q.dtype} not bf16/fp32")
    _check_scales(q, k_scale, v_scale, kpool.shape[1], kpool.shape[2])
    nb = _check_vis(q, kpool, vis, num_active_blocks)
    lib = _library()
    fn = lib.stream_decode_q8_bf16 if q.dtype == torch.bfloat16 \
        else lib.stream_decode_q8_f32
    s_slots, h, hd = q.shape
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), vis.data_ptr(),
            out.data_ptr(), s_slots, h, kpool.shape[1], kpool.shape[2], nb,
            int(li), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_flash_decode_stream_flat_q8")
    launched(paged_flash_decode_stream_flat_q8)
    return out


def _flat_pool(name, pool, h, hd):
    """A 5-D (L, NB, BS, H, hd) pool as the flat (L, NB, BS, H*hd) view of
    the same bytes (no copy); a flat pool as it is."""
    if pool.dim() != 5:
        return pool
    _require(tuple(pool.shape[3:]) == (h, hd),
             f"{name} heads {tuple(pool.shape[3:])} != q's ({h}, {hd})")
    _require(pool.is_contiguous(), f"{name} must be contiguous")
    return pool.view(*pool.shape[:3], h * hd)


def paged_flash_decode(q, kpool, vpool, tables, index, li):
    """K7: flash decode through per-slot block tables over a bf16 (or fp32)
    pool, 5-D (L, NB, BS, H, hd) or flat (L, NB, BS, H*hd); ``tables`` (S,
    MB) int32, ``index`` (S,) int32. q's dtype must match the pool's. The
    table entries a slot's positions reach must name blocks of the pool,
    as for the TPU kernel: checking them would make the host wait for the
    card. Returns (S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, kpool, vpool, tables, index, li)
    _require(q.dim() == 3, f"q must be (S, H, hd), got {tuple(q.shape)}")
    s_slots, h, hd = q.shape
    kpool, vpool = (_flat_pool("kpool", kpool, h, hd),
                    _flat_pool("vpool", vpool, h, hd))
    _check_pools(q, kpool, vpool, li, (torch.bfloat16, torch.float32),
                 index=index)
    _require(q.dtype == kpool.dtype,
             f"q dtype {q.dtype} != pool dtype {kpool.dtype}")
    _require(tables.dtype == torch.int32 and tables.dim() == 2
             and tables.shape[0] == s_slots and tables.shape[1] >= 1,
             f"tables must be int32 ({s_slots}, MB) with MB >= 1, got "
             f"{tables.dtype} {tuple(tables.shape)}")
    _require(tables.device == q.device and tables.is_contiguous(),
             f"tables must be contiguous on {q.device}, got {tables.device}")
    lib = _library()
    fn = lib.table_decode_bf16 if q.dtype == torch.bfloat16 \
        else lib.table_decode_f32
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            tables.data_ptr(), index.data_ptr(), out.data_ptr(), s_slots, h,
            kpool.shape[1], kpool.shape[2], tables.shape[1], int(li),
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_flash_decode")
    launched(paged_flash_decode)
    return out


paged_flash_decode_owner.launches = 0
paged_flash_decode_owner_q8.launches = 0
paged_flash_decode_stream_flat.launches = 0
paged_flash_decode_stream_flat_q8.launches = 0
paged_flash_decode.launches = 0


# ---------------------------------------------------------------------------
# A kernel against its plain version (card tests and chip_smoke.py)
# ---------------------------------------------------------------------------

def serving_case(quant: bool, dtype, device, seed: int = 0):
    """Arguments of one K2 (``quant``) or K1 call at the serving shapes:
    16 slots, a 12-layer pool of 256 64-token blocks with rows of 8 heads of
    64, each slot owning a 14-block region, layer 7. Live prefixes are drawn
    up to a region's end; slot 0 fills its region, slots 2 and 3 end on a
    block boundary and at position 0, slots 1 and 9 are inactive."""
    s, n_layers, h, hd, bs, nb, region = 16, 12, 8, 64, 64, 256, 14
    g = torch.Generator().manual_seed(seed)
    start = torch.tensor([(i + 1) * region for i in range(s)],
                         dtype=torch.int32)
    index = torch.randint(0, region * bs, (s,), generator=g,
                          dtype=torch.int32)
    index[:4] = torch.tensor([region * bs - 1, -1, 63, 0])
    index[9] = -1
    q = torch.randn(s, h, hd, generator=g).to(dtype)
    shape = (n_layers, nb, bs, h * hd)
    if quant:
        k = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        ks = 0.02 * torch.rand(nb, bs, generator=g)
        vs = 0.02 * torch.rand(nb, bs, generator=g)
        args = [q, k, v, ks, vs, start, index]
    else:
        args = [q, torch.randn(shape, generator=g).to(dtype),
                torch.randn(shape, generator=g).to(dtype), start, index]
    return [a.to(device) for a in args] + [7]


def stream_serving_case(quant: bool, dtype, device, seed: int = 0):
    """Arguments of one K4 (``quant``) or K3 call at the serving shapes of
    the UniTok engine in stream mode: 16 slots, a 12-layer pool of 320
    64-token blocks with rows of 8 heads of 64, the bound at the whole pool
    (320), layer 7. Tables are scattered, as a ``BlockAllocator`` hands them
    out after requests of 5-9 blocks came and went; each active slot's
    position is drawn inside its blocks. Slot 1 is inactive with no table
    (a row with no visible key); slot 9 is inactive with a stale table that
    now belongs to slot 5; slot 3's only block is the pool's last, so its
    only visible keys lie in the last chunk of the prefix."""
    from ...serve.paged import BlockAllocator

    s, n_layers, h, hd, bs, nb = 16, 12, 8, 64, 64, 320
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(nb)
    held = [alloc.alloc(int(rng.integers(5, 10))) for _ in range(24)]
    for i in rng.permutation(24)[:12]:  # requests that finished
        alloc.release(held[i])
        held[i] = None
    live = [t for t in held if t is not None]
    tables = {slot: live[i] for i, slot in enumerate(
        [0, 2] + list(range(4, 9)) + list(range(10, 15)))}
    tables[15] = alloc.alloc(int(rng.integers(5, 10)))
    tables[3] = [nb - 1]
    tables[9] = tables[5]
    vis = torch.zeros(s, nb * bs, dtype=torch.int8)
    for slot, blocks in tables.items():
        last = int(rng.integers(0, len(blocks) * bs))
        for j, b in enumerate(blocks):
            n = min(bs, last + 1 - j * bs)
            if n > 0:
                vis[slot, b * bs:b * bs + n] = 1
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(s, h, hd, generator=g, device=device).to(dtype)
    shape = (n_layers, nb, bs, h * hd)
    if quant:
        kv = [torch.randint(-127, 128, shape, generator=g, device=device,
                            dtype=torch.int8) for _ in range(2)]
        scales = [0.02 * torch.rand(nb, bs, generator=g, device=device)
                  for _ in range(2)]
        return [q, *kv, *scales, vis.to(device), 7, nb]
    kv = [torch.randn(shape, generator=g, device=device).to(dtype)
          for _ in range(2)]
    return [q, *kv, vis.to(device), 7, nb]


def table_serving_case(dtype, device, seed: int = 0, block_size: int = 64,
                       max_blocks: int = 14):
    """Arguments of one K7 call at UniSE serving width: 16 slots, a 12-layer
    flat pool of 20,480 tokens (320 64-token blocks) with rows of 8 heads of
    64, layer 7, tables of 14 blocks (UniSE's 896-token cap) scattered by a
    ``BlockAllocator`` after requests of 2-9 blocks came and went. Entries
    past a slot's allocation are ``TRASH_BLOCK``, whose rows hold values
    x100. Slot 0 sits at position MB*BS-1, slot 2 on the last row of its
    third block, slot 3 at position 0, slot 4 past its table (index
    MB*BS+37, so the whole table is attended), slot 6's table repeats a
    physical block inside its live prefix; slots 1 and 9 are inactive
    (slot 9 with a stale table, now slot 5's); the rest sit at random
    positions inside their allocations. ``block_size``/``max_blocks`` cut
    the same pool into other blocks and tables."""
    from ...serve.paged import TRASH_BLOCK, BlockAllocator

    s, n_layers, h, hd = 16, 12, 8, 64
    bs, nb, mb = block_size, 20480 // block_size, max_blocks
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(nb)
    held = [alloc.alloc(int(rng.integers(2, 10))) for _ in range(20)]
    for i in rng.permutation(20)[:10]:  # requests that finished
        alloc.release(held[i])
    tables = np.full((s, mb), TRASH_BLOCK, np.int32)
    index = np.full(s, -1, np.int32)
    sizes = {0: mb, 2: 3, 3: 1, 4: mb, 6: 6}  # blocks; the rest drawn
    for slot in [0, 2, 3, 4, 5, 6, 7, 8] + list(range(10, 16)):
        n = sizes[slot] if slot in sizes else int(rng.integers(1, mb + 1))
        tables[slot, :n] = alloc.alloc(n)
        index[slot] = rng.integers(0, n * bs)
    index[[0, 2, 3, 4, 6]] = [mb * bs - 1, 3 * bs - 1, 0, mb * bs + 37,
                              5 * bs + 10]
    tables[6, 3] = tables[6, 1]  # logical blocks 1 and 3: one physical block
    tables[9] = tables[5]
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(s, h, hd, generator=g, device=device).to(dtype)
    kv = []
    for _ in range(2):
        pool = torch.randn((n_layers, nb, bs, h * hd), generator=g,
                           device=device)
        pool[:, TRASH_BLOCK] *= 100
        kv.append(pool.to(dtype))
    return [q, *kv, torch.as_tensor(tables, device=device),
            torch.as_tensor(index, device=device), 7]


def _within(out, want, dtype):
    """-> (max abs error, ``out`` within the tolerance of ``dtype`` around
    ``want``): fp32 within 1e-5 abs + 1e-5 rel; bf16 within 2 bf16 ulps of
    ``want`` (ulp floored at that of 2**-8)."""
    err = (out - want).abs()
    if dtype == torch.float32:
        ok = bool((err <= 1e-5 + 1e-5 * want.abs()).all())
    else:
        ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
            torch.log2(want.abs().clamp(min=2.0 ** -8))))
        ok = bool((err <= 2 * ulp).all())
    return err.max().item(), ok and bool(torch.isfinite(out).all())


def compare_with_plain(kernel, ref, args, empty=None):
    """Run ``kernel(*args)`` and ``ref`` on the same values in fp32.

    Returns (max abs error, within tolerance). Tolerance: fp32 q within
    1e-5 abs + 1e-5 rel (another summation order); bf16 q within 2 bf16 ulps
    of the fp32 plain result (ulp floored at that of 2**-8), since the
    kernel rounds its output to bf16. ``empty`` (S,) bool marks the rows
    with no visible key, which must be exact zeros; by default the owner
    and table kernels' inactive slots (``index < 0``, the next-to-last
    argument)."""
    if empty is None:
        empty = args[-2] < 0
    out = kernel(*args).float()
    up = [a.float() if torch.is_tensor(a) and a.is_floating_point() else a
          for a in args]
    err, ok = _within(out, ref(*up), args[0].dtype)
    return err, ok and bool((out[empty] == 0).all())


def compare_kernels(out, other, empty):
    """Two kernels' outputs for the same function on the same inputs (K7
    against K1 or K3) -> (max abs error, within tolerance): the tolerance of
    :func:`compare_with_plain` around ``other``, whose rounding to bf16 may
    differ by one ulp; the ``empty`` rows exact zeros in both."""
    err, ok = _within(out.float(), other.float(), out.dtype)
    return err, ok and bool((out[empty] == 0).all()) \
        and bool((other[empty] == 0).all())
