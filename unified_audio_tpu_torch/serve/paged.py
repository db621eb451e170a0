"""Paged KV cache: a block pool shared by all serving slots.

Port of ``unified_audio_tpu/serve/paged.py``: ``init_pool`` (flat
(L, NB, BS, H*hd) layout; int8 pools carry fp32 per-token scales; the
Moonlight stack's latent pool, which the JAX package lacks, holds one
(L, NB, BS, rank + rope) entry),
``quantize_kv``, ``BlockAllocator``, ``RegionAllocator``, ``scatter_prefill``,
``PoolRef`` and the one-token decode step ``paged_decode_ids`` /
``paged_decode_embeds`` (``latent_decode_embeds`` over a latent pool).

The decode step's attention runs in one of three modes:

* ``""``: the plain attention, the reference. Every slot attends over the
  pool prefix with a block-ownership mask, in the rounding order of the JAX
  package's plain path.
* ``"owner"``: each slot attends only to its own contiguous region (the
  ``RegionAllocator`` contract) through the owner kernels K1/K2
  (``ops/cuda/paged_attention.py``): CUDA kernels for tensors on the card,
  their plain versions for tensors on the CPU.
* ``"stream"``: every slot against the visible keys of the pool prefix
  through the stream kernels K3/K4, with the layer-invariant int8
  visibility mask built once per step; pairs with the ``BlockAllocator``
  and is the mode of a pool shared by several engines (``PoolRef``).

Pool updates happen in place (``index_put_``): the pool is the largest
buffer of the server and a functional update would copy it every step.
Physical block 0 is a reserved trash block: inactive slots write there, at
distinct offsets, so a stale block table never corrupts a live slot and the
scatter never carries duplicate indices (whose result is undefined).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import torch

from ..models.lm.llama import NEG_INF, LlamaConfig
from ..nn.transformer import apply_rope, rms_norm, rope_cos_sin
from ..ops.cuda.paged_attention import (paged_flash_decode_owner,
                                        paged_flash_decode_owner_q8,
                                        paged_flash_decode_stream_flat,
                                        paged_flash_decode_stream_flat_q8)

TRASH_BLOCK = 0  # physical block 0 is never allocated; inactive slots write here
# owner-mode regions round up to a multiple of this many blocks: the JAX
# package's owner geometry (14-block regions for UniSE serving), so both
# packages lay the pool out alike; the CUDA kernels need no chunking
OWNER_CHUNK_BLOCKS = 14
KERNEL_MODES = ("", "owner", "stream")


def init_pool(cfg, num_blocks: int, block_size: int,
              dtype=torch.float32, quant: Optional[str] = None,
              device=None, tp: int = 1) -> Dict[str, torch.Tensor]:
    """Block pool stored flat, one (L, NB, BS, width) entry per entry of
    the config's ``cache_rows``: {k, v: (L, NB, BS, H*hd)} for the Llama
    stack, {kv: (L, NB, BS, rank + rope)} (the latent rows) for
    Moonlight's. ``quant="int8"`` (K/V pools only) stores symmetric int8
    K/V with one fp32 scale per (layer, block, offset) in
    ``k_scale``/``v_scale`` (L, NB, BS). Under tensor parallelism a rank
    keeps its H/tp heads: the flat width is H*hd/tp (``tp``)."""
    rows = cfg.cache_rows
    if "kv" in rows and (quant is not None or tp != 1):
        raise ValueError("a latent pool holds bf16/fp32 rows that every "
                         "head shares: no int8 quant, no tp cut")
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} does not divide {cfg.num_heads} heads")
    shapes = {k: (cfg.num_layers, num_blocks, block_size, w // tp)
              for k, w in rows.items()}
    if quant is None:
        return {k: torch.zeros(shape, dtype=dtype, device=device)
                for k, shape in shapes.items()}
    if quant != "int8":
        raise ValueError(f"unknown pool quant {quant!r} (int8 or None)")
    shape = shapes["k"]
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], device=device),
            "v_scale": torch.zeros(shape[:3], device=device)}


def quantize_kv(x):
    """Symmetric per-row int8: x (..., DH) -> (int8 (..., DH), fp32 scale
    (...,)). ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp(min=1e-20)[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


class BlockAllocator:
    """Host-side free list of physical blocks (block 0 reserved as trash),
    lowest block first, so allocated blocks cluster at the bottom of the
    pool and ``high_water()`` bounds the allocated prefix."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.free: List[int] = list(range(1, num_blocks))
        heapq.heapify(self.free)
        self._allocated: set = set()

    def alloc(self, n: int) -> List[int]:
        if len(self.free) < n:
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {len(self.free)} free")
        out = [heapq.heappop(self.free) for _ in range(n)]
        self._allocated.update(out)
        return out

    def release(self, blocks: List[int]):
        for b in blocks:
            heapq.heappush(self.free, int(b))
            self._allocated.discard(int(b))

    def high_water(self) -> int:
        """1 + the highest allocated block index (>= 1: the trash block)."""
        return (max(self._allocated) + 1) if self._allocated else 1

    def bounded_high_water(self, bucket: int = 64) -> int:
        b = -(-self.high_water() // bucket) * bucket
        return min(b, self.num_blocks)

    def block_cost(self, n: int) -> int:
        """Blocks that alloc(n) consumes (admission budgets charge this)."""
        return n


class RegionAllocator:
    """Contiguous region allocator for the owner-mode decode kernels.

    The pool is cut into regions of ``region_blocks`` blocks; ``alloc(n)``
    hands out the first ``n`` blocks of a whole free region, so every slot's
    blocks are contiguous and in the pool. Region 0 holds the trash block
    and is never allocated. Allocation interface as :class:`BlockAllocator`
    (``free``/``alloc``/``release``/``block_cost``); a request is charged a
    whole region."""

    def __init__(self, num_blocks: int, region_blocks: int):
        if region_blocks < 1:
            raise ValueError("region_blocks must be >= 1")
        self.num_blocks = num_blocks
        self.region_blocks = region_blocks
        self.num_regions = num_blocks // region_blocks
        if self.num_regions < 2:
            raise ValueError(
                f"pool of {num_blocks} blocks holds {self.num_regions} "
                f"regions of {region_blocks}; need >= 2 (region 0 is "
                "reserved for the trash block)")
        self._free_regions: List[int] = list(range(1, self.num_regions))
        heapq.heapify(self._free_regions)
        self._allocated_regions: set = set()

    @property
    def free(self) -> List[int]:
        """Free blocks (whole free regions), as BlockAllocator.free."""
        r_blocks = self.region_blocks
        return [r * r_blocks + i for r in self._free_regions
                for i in range(r_blocks)]

    def block_cost(self, n: int) -> int:
        if n > self.region_blocks:
            raise ValueError(f"request of {n} blocks exceeds the region size "
                             f"{self.region_blocks}")
        return self.region_blocks

    def alloc(self, n: int) -> List[int]:
        self.block_cost(n)  # validates n
        if not self._free_regions:
            raise RuntimeError(f"KV pool exhausted: need a region, 0 of "
                               f"{self.num_regions - 1} free")
        r = heapq.heappop(self._free_regions)
        self._allocated_regions.add(r)
        base = r * self.region_blocks
        return [base + i for i in range(n)]

    def release(self, blocks: List[int]):
        if not blocks:
            return
        r = int(blocks[0]) // self.region_blocks
        if r not in self._allocated_regions:
            raise ValueError(f"release of unallocated region {r}")
        base = r * self.region_blocks
        for b in blocks:
            if not base <= int(b) < base + self.region_blocks:
                raise ValueError(f"block {b} outside region {r}'s range "
                                 f"[{base}, {base + self.region_blocks})")
        self._allocated_regions.discard(r)
        heapq.heappush(self._free_regions, r)

    def high_water(self) -> int:
        """1 + the highest block of an allocated region's span (>= 1: the
        trash block), as BlockAllocator.high_water."""
        if not self._allocated_regions:
            return 1
        return (max(self._allocated_regions) + 1) * self.region_blocks

    def bounded_high_water(self, bucket: int = 64) -> int:
        b = -(-self.high_water() // bucket) * bucket
        return min(b, self.num_blocks)


def visibility_mask(lmap, index, block_size: int):
    """(S, NB) inverse block map (logical block of each physical block, -1
    if not owned) + (S,) positions -> (S, NB*BS) bool key visibility."""
    s, nb = lmap.shape
    key_pos = lmap[:, :, None] * block_size + torch.arange(
        block_size, device=lmap.device)
    vis = (lmap[:, :, None] >= 0) & (key_pos <= index[:, None, None])
    return vis.reshape(s, nb * block_size)


def table_visibility(tables, index, num_blocks: int, block_size: int,
                     nb: Optional[int] = None):
    """(S, MB) block tables of a pool of ``num_blocks`` + (S,) positions ->
    (S, nb*BS) bool key visibility of the prefix [0, nb) (default the whole
    pool): the inverse block map of each table, the trash block dropped."""
    s_slots, max_blocks = tables.shape
    dev = tables.device
    rows = torch.arange(s_slots, device=dev)[:, None]
    lmap = torch.full((s_slots, num_blocks), -1, dtype=torch.long, device=dev)
    lmap[rows, tables.long()] = torch.arange(
        max_blocks, device=dev)[None].expand(s_slots, max_blocks)
    lmap[:, TRASH_BLOCK] = -1
    nb = num_blocks if nb is None else nb
    return visibility_mask(lmap[:, :nb], index, block_size)


def pool_blocks(pool) -> int:
    """Blocks of a pool (any stack's)."""
    return next(iter(pool.values())).shape[1]


def _write_targets(tables, index, active, bs: int):
    """(block, offset) of each slot's new row -> two (S,) long tensors;
    inactive slots go to the trash block at distinct offsets (slot counts
    never exceed block_size here)."""
    s_slots, max_blocks = tables.shape
    if s_slots > bs:
        raise ValueError(f"{s_slots} slots exceed block_size {bs}: the "
                         "trash-block offsets would collide")
    slot_ids = torch.arange(s_slots, device=tables.device)
    # an inactive slot's stale index may point past its table: clamp the
    # lookup (its row is redirected to the trash block anyway)
    cur = (index // bs).long().clamp(0, max_blocks - 1)
    blk = torch.gather(tables, 1, cur[:, None])[:, 0]
    blk = torch.where(active, blk, TRASH_BLOCK).long()
    off = torch.where(active, index % bs, slot_ids % bs).long()
    return blk, off


def _plain_attention(q, pool, li, mask, nb, x_dtype):
    """The reference attention (mode ""): every slot against the pool
    prefix [0, nb) under ``mask`` (S, 1, 1, nb*BS); int8 pools dequantize
    by row (k scale on the logits, v scale on the probabilities)."""
    s_slots, _, h, hd = q.shape
    k_buf = pool["k"][li, :nb]
    v_buf = pool["v"][li, :nb]
    quant = "k_scale" in pool
    if quant:
        ksc = pool["k_scale"][li, :nb].reshape(-1)
        vsc = pool["v_scale"][li, :nb].reshape(-1)
        k_buf, v_buf, q = k_buf.float(), v_buf.float(), q.float()
    k_buf = k_buf.reshape(-1, h, hd)
    v_buf = v_buf.reshape(-1, h, hd)
    logits = torch.einsum("bqhd,khd->bhqk", q, k_buf).float()
    if quant:
        logits = logits * (ksc * hd ** -0.5) + mask
    else:
        logits = logits * hd ** -0.5 + mask
    probs = torch.softmax(logits, dim=-1).to(x_dtype)
    if quant:
        probs = probs * vsc.to(probs.dtype)
    return torch.einsum("bhqk,khd->bqhd", probs, v_buf.to(probs.dtype))


def paged_decode_embeds(cfg: LlamaConfig, lm, pool, tables, index, active, x,
                        block_size: int,
                        num_active_blocks: Optional[int] = None,
                        use_kernel: str = ""):
    """One batched decode step over the paged pool, per-slot positions.

    ``lm`` supplies ``layers`` and ``norm`` (a CodecLM); tables (S, MB)
    int32, index (S,) int32, active (S,) bool, x (S, 1, D) input
    embeddings. Writes each active slot's new K/V at (block, offset) of its
    current position, in place, and returns the normed hidden (S, D).

    ``num_active_blocks`` bounds the pool prefix the plain and stream
    attention read (it must be >= the allocator's high water); the owner
    mode reads only each slot's own region and ignores it.
    ``use_kernel="owner"`` requires contiguous per-slot regions
    (``RegionAllocator``).

    Under tensor parallelism (``lm`` cut by ``parallel/mesh.py
    shard_lm_``, the pool made with ``init_pool(..., tp=)``) every rank
    runs the step on its H/tp heads: its rows of the pool, the kernels and
    their plain versions over those heads; ``o_proj`` and the MLP sum
    their partial outputs over tp."""
    if use_kernel not in KERNEL_MODES:
        raise ValueError(f"unknown kernel mode {use_kernel!r}")
    bs = block_size
    s_slots, max_blocks = tables.shape
    num_blocks = pool_blocks(pool)
    nb = num_blocks if num_active_blocks is None \
        else min(int(num_active_blocks), num_blocks)
    h, hd = lm.layers[0].self_attn.local_heads, cfg.head_dim
    quant = "k_scale" in pool
    index = index.int()
    cos, sin = rope_cos_sin(index[:, None], hd, cfg.rope_theta)

    if use_kernel == "owner":
        start = tables[:, 0].contiguous()
        own_index = torch.where(active, index, -1).int()
    else:
        # layer-invariant key visibility, built once per step
        vis = table_visibility(tables, index, num_blocks, bs, nb)
        if use_kernel == "stream":
            vis_i8 = vis.to(torch.int8)
        else:
            mask = torch.where(vis, 0.0, NEG_INF).reshape(s_slots, 1, 1,
                                                          nb * bs)

    blk, off = _write_targets(tables, index, active, bs)

    for li, layer in enumerate(lm.layers):
        attn_mod = layer.self_attn
        hin = layer.input_layernorm(x)
        q, k, v = (t.view(s_slots, 1, h, hd)
                   for t in attn_mod.project_in(hin))
        q, k = apply_rope(q, k, cos, sin)
        k_rows = k[:, 0].reshape(s_slots, h * hd)
        v_rows = v[:, 0].reshape(s_slots, h * hd)
        if quant:
            k_rows, k_sc = quantize_kv(k_rows)
            v_rows, v_sc = quantize_kv(v_rows)
            pool["k_scale"][li, blk, off] = k_sc
            pool["v_scale"][li, blk, off] = v_sc
        pool["k"][li, blk, off] = k_rows.to(pool["k"].dtype)
        pool["v"][li, blk, off] = v_rows.to(pool["v"].dtype)
        if use_kernel == "owner":
            q0 = q[:, 0].contiguous()
            if quant:
                attn = paged_flash_decode_owner_q8(
                    q0, pool["k"], pool["v"], pool["k_scale"][li],
                    pool["v_scale"][li], start, own_index, li)
            else:
                attn = paged_flash_decode_owner(q0, pool["k"], pool["v"],
                                                start, own_index, li)
        elif use_kernel == "stream":
            q0 = q[:, 0].contiguous()
            if quant:
                attn = paged_flash_decode_stream_flat_q8(
                    q0, pool["k"], pool["v"], pool["k_scale"][li],
                    pool["v_scale"][li], vis_i8, li, nb)
            else:
                attn = paged_flash_decode_stream_flat(
                    q0, pool["k"], pool["v"], vis_i8, li, nb)
        else:
            attn = _plain_attention(q, pool, li, mask, nb, x.dtype)
        attn = attn.reshape(s_slots, 1, h * hd).to(x.dtype)
        x = x + attn_mod.project_out(attn)
        x = x + layer.mlp(layer.post_attention_layernorm(x))
    return rms_norm(x, lm.norm.weight)[:, 0]


def latent_decode_embeds(cfg, lm, pool, tables, index, active, x,
                         block_size: int,
                         num_active_blocks: Optional[int] = None,
                         use_kernel: str = ""):
    """One batched decode step of the Moonlight stack over a latent pool
    {kv: (L, NB, BS, rank + rope)}, per-slot positions; arguments as
    :func:`paged_decode_embeds`, whose contract it keeps (each active
    slot's new row written in place, inactive slots' to the trash block;
    the normed hidden (S, D) returned).

    Each slot attends, in the absorbed form (``moonlight.py``), to the
    rows of its own blocks where they lie in the pool, through its table
    (in the owner mode its contiguous region, in the others the blocks its
    table names), up to its index: K8 (``ops/cuda/latent_attention.py``)
    on the card, its plain version on the CPU. An inactive slot attends to
    nothing (its index goes in as -1). No host read: the step captures as a
    CUDA graph. ``num_active_blocks`` is not needed (no slot reads past its
    table)."""
    if use_kernel not in KERNEL_MODES:
        raise ValueError(f"unknown kernel mode {use_kernel!r}")
    index = index.int()
    cos, sin = rope_cos_sin(index[:, None], cfg.rope_dim, cfg.rope_theta)
    blk, off = _write_targets(tables, index, active, block_size)
    tables = tables.int().contiguous()
    own_index = torch.where(active, index, -1).int()
    for li, layer in enumerate(lm.layers):
        x = x + layer.self_attn.paged(layer.input_layernorm(x), cos, sin,
                                      pool["kv"][li], blk, off, tables,
                                      own_index)
        x = x + layer.mlp(layer.post_attention_layernorm(x))
    return lm.norm(x)[:, 0]


def paged_decode_ids(cfg, lm, pool, tables, index, active, ids,
                     block_size: int, num_active_blocks: Optional[int] = None,
                     use_kernel: str = ""):
    """Token-level decode step: ids (S,) -> (logits (S, V) fp32); the pool
    is updated in place. Activations follow the embedding's dtype. A
    latent pool (``kv``) runs :func:`latent_decode_embeds`, a K/V pool
    :func:`paged_decode_embeds`."""
    x = lm.embed_codes(ids.long())[:, None]
    step = latent_decode_embeds if "kv" in pool else paged_decode_embeds
    hidden = step(cfg, lm, pool, tables, index, active, x, block_size,
                  num_active_blocks, use_kernel)
    return lm.head(hidden).float()


def scatter_prefill(pool, tables, cache_k, cache_v, block_size: int):
    """Write a dense prefilled cache into the pool, in place.

    cache_k/cache_v (L, B, Lp, H, hd); tables (B, MB). Position p of row b
    lands in block ``tables[b, p // BS]`` at offset ``p % BS``."""
    bs = block_size
    n_layers, b, lp_len, h, hd = cache_k.shape
    cache_k = cache_k.reshape(n_layers, b, lp_len, h * hd)
    cache_v = cache_v.reshape(n_layers, b, lp_len, h * hd)
    pos = torch.arange(lp_len, device=cache_k.device)
    blk = tables.long()[:, pos // bs]  # (B, Lp)
    off = (pos % bs).expand_as(blk)
    if "k_scale" in pool:
        cache_k, k_sc = quantize_kv(cache_k)
        cache_v, v_sc = quantize_kv(cache_v)
        pool["k_scale"][:, blk, off] = k_sc
        pool["v_scale"][:, blk, off] = v_sc
    pool["k"][:, blk, off] = cache_k.to(pool["k"].dtype)
    pool["v"][:, blk, off] = cache_v.to(pool["v"].dtype)
    return pool


def scatter_cache(pool, tables, cache, block_size: int):
    """Write a dense prefilled cache (either stack's ``init_cache``) into
    the pool, in place: a K/V cache through :func:`scatter_prefill`, a
    latent cache {kv: (L, B, Lp, rank + rope)} row by row alike."""
    if "kv" not in cache:
        return scatter_prefill(pool, tables, cache["k"], cache["v"],
                               block_size)
    rows = cache["kv"]
    pos = torch.arange(rows.shape[2], device=rows.device)
    blk = tables.long()[:, pos // block_size]  # (B, Lp)
    pool["kv"][:, blk, (pos % block_size).expand_as(blk)] = rows.to(
        pool["kv"].dtype)
    return pool


class PoolRef:
    """Shared handle to one physical KV block pool: engines built with the
    same ``PoolRef`` and the same allocator serve from one pool (the
    allocator partitions its blocks between them). The port updates pools
    in place, so the handle only carries the dict."""

    def __init__(self, pool: Dict[str, torch.Tensor]):
        self.pool = pool


def kernel_mode(use_kernel: Optional[str], device: torch.device) -> str:
    """An engine's decode attention mode: ``use_kernel`` if given, else the
    owner kernels on CUDA and the plain attention on the CPU."""
    if use_kernel is None:
        use_kernel = "owner" if device.type == "cuda" else ""
    if use_kernel not in KERNEL_MODES:
        raise ValueError(f"use_kernel={use_kernel!r}: expected None, '', "
                         "'owner' or 'stream'")
    return use_kernel


def open_pool(cfg, num_slots: int, max_blocks: int,
              block_size: int, use_kernel: str, dtype, device,
              kv_quant: Optional[str] = None,
              num_blocks: Optional[int] = None,
              pool_ref: Optional[PoolRef] = None, allocator=None):
    """The pool an engine serves from -> (pool_ref, allocator, kv_quant).

    With ``pool_ref`` (and its ``allocator``) the engine shares another
    engine's pool, whose storage format decides ``kv_quant``. Otherwise a
    new pool of ``num_blocks`` (default: in the owner mode a region per
    slot, the trash region and a spare; in the plain and stream modes a
    table of ``max_blocks`` per slot and the trash block; rounded up to the
    64-block buckets of the decode bound) with a ``RegionAllocator`` (owner)
    or a ``BlockAllocator``. The owner mode needs regions of at least
    ``max_blocks``."""
    owner = use_kernel == "owner"
    region_blocks = (-(-max_blocks // OWNER_CHUNK_BLOCKS)
                     * OWNER_CHUNK_BLOCKS)
    if pool_ref is not None:
        if allocator is None:
            raise ValueError("a shared pool needs its allocator")
        shared = "int8" if "k_scale" in pool_ref.pool else None
        if kv_quant is not None and kv_quant != shared:
            raise ValueError(f"kv_quant={kv_quant!r} conflicts with the "
                             f"shared pool's ({shared!r})")
        kv_quant = shared
    else:
        if num_blocks is None:
            need = ((num_slots + 2) * region_blocks if owner
                    else 1 + num_slots * max_blocks)
            num_blocks = -(-need // 64) * 64
        pool_ref = PoolRef(init_pool(cfg, num_blocks, block_size,
                                     dtype=dtype, quant=kv_quant,
                                     device=device))
        if allocator is None:
            allocator = (RegionAllocator(num_blocks, region_blocks) if owner
                         else BlockAllocator(num_blocks))
    if owner and not (isinstance(allocator, RegionAllocator)
                      and allocator.region_blocks >= max_blocks):
        raise ValueError("use_kernel='owner' needs a RegionAllocator with "
                         f"regions of >= {max_blocks} blocks")
    return pool_ref, allocator, kv_quant
