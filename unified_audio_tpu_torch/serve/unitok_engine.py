"""Continuous-batching engine for UniTok over the paged KV pool.

Port of ``unified_audio_tpu/serve/unitok_engine.py`` (``UniTokEngine``,
``UniTokRequest``, ``UniTokResult``). The UniTok LM decodes K codebooks per
step through a Llama backbone of the UniSE LM's geometry, so its KV blocks
fit the same pool: with one ``PoolRef`` and one allocator a
``ContinuousBatchingEngine`` (UniSE) and a ``UniTokEngine`` serve from one
pool, each stepped in turn.

* ``admit_wave`` takes requests of one signature (the feature buckets of
  the caption, reference and input segments) into free slots: the prompt
  ``[task][C][caption][R][ref][I][input][S]`` padded to the buckets, each
  row's own task embedding, the valid tokens compacted to the left (a
  stable sort), one prefill for the wave, scattered into each request's
  blocks. A request costs ``ceil((plen + steps + 1) / BS)`` blocks, ``plen``
  the padded prompt length.
* ``step(n)`` decodes n steps for every active slot: the sum of the K code
  embeddings, the paged decode step, the K heads as one stacked product,
  the delay window (codebook k takes real codes for steps [k, k +
  num_frames), PAD outside) and per-row sampling (greedy rows take the
  argmax). Inactive rows are masked out of every state write.
* ``harvest`` undoes the delay on the host and frees the slots (one
  device read). Decode lengths are fixed (num_frames + K - 1 steps), so the
  host knows each completion without reading the device.
* ``admit_wave`` reuses a slot whose request finished but was not
  harvested without a device read: its codes are copied into a
  device-side stash first, and ``drain_stashes`` fetches every pending
  stash in one read.
* ``run`` admits waves, one signature each, while slots last, then
  decodes to the next completion in power-of-two chunks; the stashed codes
  are fetched in one read at the end.

The JAX engine pads each wave to the slot count so that it compiles one
prefill program; the port's eager prefill takes the wave as it is.

The attention mode follows the JAX package's policy: the owner kernels
(``"owner"``, a ``RegionAllocator``) on CUDA, the plain attention (``""``)
on the CPU, unless ``use_kernel`` asks for one of them or for ``"stream"``
(the stream kernels K3/K4 over a ``BlockAllocator``, the mode of a shared
pool).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.lm.llama import init_cache, sample_logits_vec
from ..models.unitok.model import UniTokLM, delay_window_masks
from .engine import _pick_bucket, h2d, segment_chunks
from .paged import (TRASH_BLOCK, PoolRef, kernel_mode, open_pool,
                    paged_decode_embeds, scatter_prefill)


@dataclass
class UniTokRequest:
    task_id: int
    num_frames: int
    caption_feats: Optional[np.ndarray] = None  # (Tc, text_dim)
    ref_feats: Optional[np.ndarray] = None      # (Tr, audio_dim)
    input_feats: Optional[np.ndarray] = None    # (Ti, audio_dim)
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    do_sample: bool = True
    uid: int = 0


@dataclass
class UniTokResult:
    uid: int
    codes: np.ndarray  # (num_frames, K)


class UniTokEngine:
    """Slot-pool continuous batching for the delay-pattern LM."""

    def __init__(
        self,
        lm: UniTokLM,
        num_slots: int = 8,
        block_size: int = 64,
        num_blocks: Optional[int] = None,
        max_frames: int = 256,
        feat_buckets: Sequence[int] = (64, 128, 256),
        max_top_k: int = 256,
        pool_ref: Optional[PoolRef] = None,
        allocator=None,
        use_kernel: Optional[str] = None,
        kv_quant: Optional[str] = None,
    ):
        """``lm`` is already on its device and in its serving dtype (the
        pool and activations follow it). ``feat_buckets`` are the frame
        lengths the caption, reference and input segments pad to.
        ``pool_ref`` and ``allocator`` (given together) share another
        engine's pool, whose storage format then decides ``kv_quant``."""
        self.lm = lm
        self.cfg = cfg = lm.cfg
        self.lcfg = cfg.llama_config
        self.K = cfg.num_codebooks
        weight = lm.code_embeddings[0].weight
        self.device = weight.device
        self.kv_dtype = weight.dtype
        self.use_kernel = kernel_mode(use_kernel, self.device)
        if num_slots > block_size:
            raise ValueError(f"num_slots {num_slots} > block_size "
                             f"{block_size}: inactive slots need distinct "
                             "trash-block offsets")
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_frames = max_frames
        self.feat_buckets = tuple(sorted(feat_buckets))
        self.max_top_k = max_top_k
        self.max_steps = max_frames + self.K - 1
        # table width: the largest prompt (three full segments and four
        # separators) and the longest decode
        max_tokens = 5 + 3 * self.feat_buckets[-1] + self.max_steps + 1
        self.max_blocks = math.ceil(max_tokens / block_size)
        self._pool_ref, self.allocator, self.kv_quant = open_pool(
            self.lcfg, num_slots, self.max_blocks, block_size,
            self.use_kernel, self.kv_dtype, self.device, kv_quant, num_blocks,
            pool_ref, allocator)
        self.num_blocks = self.pool["k"].shape[1]

        # the K heads stacked (K, V, D): one product per step
        self._heads = torch.stack([h.weight for h in lm.heads])
        self._code_mask, self._pad_only = delay_window_masks(cfg, self.device)

        s, dev = num_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = {
            "active": torch.zeros((s,), dtype=torch.bool, device=dev),
            "step": torch.zeros((s,), **i32),
            "num_frames": torch.zeros((s,), **i32),
            "last_ids": torch.zeros((s, self.K), **i32),
            "do_sample": torch.zeros((s,), dtype=torch.bool, device=dev),
            "temperature": torch.ones((s,), device=dev),
            "top_k": torch.ones((s,), **i32),
            "top_p": torch.ones((s,), device=dev),
            "index": torch.zeros((s,), **i32),
            "block_tables": torch.full((s, self.max_blocks), TRASH_BLOCK,
                                       **i32),
            "out": torch.zeros((s, self.max_steps, self.K), **i32),
        }
        # host-side mirrors: decode lengths are fixed, so the host knows
        # when each slot finishes without reading the device
        self._slot_blocks: List[List[int]] = [[] for _ in range(s)]
        self._uids: List[Optional[int]] = [None] * s
        self._remaining: List[int] = [0] * s
        # finished slots whose blocks are released (displaceable), and the
        # stashes of displaced slots: (uids, (n, max_steps * K + 1) int32)
        self._done_slots: set = set()
        self._pending_stashes: List[tuple] = []
        self._stats = {"requests_admitted": 0, "requests_completed": 0,
                       "frames_generated": 0, "decode_steps": 0,
                       "step_dispatches": 0, "prefill_waves": 0,
                       "stash_fetches": 0}

    @property
    def pool(self) -> Dict[str, torch.Tensor]:
        return self._pool_ref.pool

    # --- admission ---

    def _signature(self, r: UniTokRequest):
        def seg(x, what):
            return (None if x is None
                    else _pick_bucket(len(x), self.feat_buckets, what))

        return (seg(r.caption_feats, "caption"), seg(r.ref_feats, "ref"),
                seg(r.input_feats, "input"))

    def validate(self, req: UniTokRequest) -> None:
        """Reject requests that can never run under the engine's caps."""
        if not 1 <= req.num_frames <= self.max_frames:
            raise ValueError(f"num_frames {req.num_frames} not in "
                             f"[1, {self.max_frames}]")
        if req.temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {req.temperature}")
        if not 0 < req.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {req.top_p}")
        if not 1 <= req.top_k <= self.max_top_k:
            raise ValueError(f"top_k {req.top_k} not in [1, {self.max_top_k}]")
        if not 0 <= req.task_id < self.cfg.num_tasks:
            raise ValueError(f"task_id {req.task_id} not in "
                             f"[0, {self.cfg.num_tasks})")
        self._signature(req)  # raises on an over-long segment

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if self._uids[i] is None]

    def _reap_host(self) -> None:
        """Slots whose request finished (host-known) give their blocks back
        and become displaceable; their outputs stay in the state until a
        displacing insert stashes them."""
        for s in range(self.num_slots):
            if (self._uids[s] is not None and self._remaining[s] == 0
                    and s not in self._done_slots):
                self._done_slots.add(s)
                self.allocator.release(self._slot_blocks[s])
                self._slot_blocks[s] = []

    def _open_slots(self) -> List[int]:
        """Slots an admission may take: free ones and (reaped first) those
        whose request finished."""
        self._reap_host()
        return [s for s in range(self.num_slots)
                if self._uids[s] is None or s in self._done_slots]

    def _outputs(self, rows=None) -> torch.Tensor:
        """(n, max_steps * K + 1) int32: each slot's (or ``rows``') delayed
        codes and frame count, packed for one device read."""
        st = self.state
        parts = [st["out"].flatten(1), st["num_frames"][:, None]]
        if rows is not None:
            parts = [p[rows] for p in parts]
        return torch.cat(parts, dim=1)

    def _results(self, uids, packed: np.ndarray) -> List[UniTokResult]:
        out = [self._undelay(uid, row[:-1].reshape(self.max_steps, self.K),
                             int(row[-1]))
               for uid, row in zip(uids, packed)]
        self._stats["requests_completed"] += len(out)
        self._stats["frames_generated"] += sum(len(r.codes) for r in out)
        return out

    def _segment(self, take, get, bucket, dim):
        """(B, bucket, dim) zero-padded features of one segment kind and
        the (B, bucket) validity of its positions; (None, None) when the
        wave's signature has no such segment."""
        if bucket is None:
            return None, None
        feats = np.zeros((len(take), bucket, dim), np.float32)
        lens = np.zeros((len(take), 1), np.int64)
        for i, (_, r, _) in enumerate(take):
            x = np.asarray(get(r), np.float32)
            feats[i, :len(x)] = x
            lens[i] = len(x)
        valid = (torch.arange(bucket, device=self.device)[None]
                 < h2d(lens, self.device))
        return h2d(feats, self.device), valid

    @torch.no_grad()
    def admit_wave(self, reqs: List[UniTokRequest]) -> List[int]:
        """Admit the requests of ``reqs[0]``'s signature into slots while
        slots and pool blocks last; returns the uids admitted. The whole
        list is validated before any slot or block is taken. A slot whose
        request finished but was not harvested is reused without a device
        read; its codes go to a device-side stash first
        (:meth:`drain_stashes`)."""
        if not reqs:
            return []
        for r in reqs:
            self.validate(r)
        sig = self._signature(reqs[0])
        # padded prompt: task + (separator + bucket) per segment + [S]
        plen = 1 + sum(1 + b for b in sig if b is not None) + 1
        slots = self._open_slots()
        take = []  # (slot, request, blocks)
        displaced_slots, displaced_uids = [], []
        for r in reqs:
            if not slots:
                break
            if self._signature(r) != sig:
                continue
            steps = r.num_frames + self.K - 1
            need = math.ceil((plen + steps + 1) / self.block_size)
            if self.allocator.block_cost(need) > len(self.allocator.free):
                break
            blocks = self.allocator.alloc(need)
            s = slots.pop(0)
            if s in self._done_slots:
                displaced_slots.append(s)
                displaced_uids.append(self._uids[s])
                self._done_slots.discard(s)
            take.append((s, r, blocks))
            self._slot_blocks[s] = blocks
            self._uids[s] = r.uid
            self._remaining[s] = steps
        if not take:
            return []

        cfg, dev, b = self.cfg, self.device, len(take)
        cap, cap_ok = self._segment(take, lambda r: r.caption_feats, sig[0],
                                    cfg.text_dim)
        ref, ref_ok = self._segment(take, lambda r: r.ref_feats, sig[1],
                                    cfg.audio_dim)
        inp, inp_ok = self._segment(take, lambda r: r.input_feats, sig[2],
                                    cfg.audio_dim)
        task_ids = h2d([r.task_id for _, r, _ in take], dev)
        prompt = self.lm.build_prompt(task_ids, cap, ref, inp, b)
        # compact the valid tokens to the left, in order (a stable sort):
        # positions and cache layout then match the unpadded prompt
        one = torch.ones((b, 1), dtype=torch.bool, device=dev)
        segs = [one]
        for ok in (cap_ok, ref_ok, inp_ok):
            if ok is not None:
                segs += [one, ok]
        valid = torch.cat(segs + [one], dim=1)  # (B, plen)
        order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
        prompt = torch.gather(prompt, 1, order[..., None].expand_as(prompt))
        cache = init_cache(self.lcfg, b, plen, dtype=self.kv_dtype,
                           device=dev)
        self.lm.backbone.cached_forward(prompt.to(self.kv_dtype), cache)
        tables = np.full((b, self.max_blocks), TRASH_BLOCK, np.int32)
        for i, (_, _, blocks) in enumerate(take):
            tables[i, :len(blocks)] = blocks
        tables_dev = h2d(tables, dev)
        scatter_prefill(self.pool, tables_dev, cache["k"], cache["v"],
                        self.block_size)

        st = self.state
        if displaced_slots:
            self._pending_stashes.append((displaced_uids, self._outputs(
                h2d(np.asarray(displaced_slots, np.int64), dev))))
        rows = h2d(np.asarray([s for s, _, _ in take], np.int64), dev)
        wave = [r for _, r, _ in take]

        def put(name, vals):
            if not torch.is_tensor(vals):
                vals = h2d(vals, dev)
            st[name][rows] = vals.to(st[name].dtype)

        put("active", [True] * b)
        put("step", [0] * b)
        put("num_frames", [r.num_frames for r in wave])
        put("last_ids", [[cfg.bos] * self.K] * b)
        put("do_sample", [bool(r.do_sample) for r in wave])
        put("temperature", [r.temperature for r in wave])
        put("top_k", [r.top_k for r in wave])
        put("top_p", [r.top_p for r in wave])
        put("index", valid.sum(1))
        put("block_tables", tables_dev)
        st["out"][rows] = 0
        self._stats["prefill_waves"] += 1
        self._stats["requests_admitted"] += b
        return [r.uid for r in wave]

    # --- decode ---

    def _block_bound(self) -> int:
        """Pool prefix the plain and stream attention read (the allocator's
        high water, bucketed; with a shared allocator it covers every
        engine's blocks); the owner kernels read each slot's own region."""
        if self.use_kernel == "owner":
            return self.num_blocks
        return self.allocator.bounded_high_water()

    @torch.no_grad()
    def decode_logits(self, ids) -> torch.Tensor:
        """One paged decode step from each slot's previous K codes ``ids``
        (S, K): writes the slots' new K/V into the pool (inactive rows into
        the trash block) and returns the K heads' logits (S, K, V) fp32.
        The slots' positions do not advance here."""
        st = self.state
        x = self.lm.embed_codes(ids)[:, None].to(self.kv_dtype)
        hidden = paged_decode_embeds(
            self.lcfg, self.lm.backbone, self.pool, st["block_tables"],
            st["index"], st["active"], x, self.block_size,
            num_active_blocks=self._block_bound(), use_kernel=self.use_kernel)
        return torch.einsum("sd,kvd->skv", hidden,
                            self._heads.to(hidden.dtype)).float()

    def step(self, n: int = 1,
             generator: Optional[torch.Generator] = None) -> None:
        """Decode ``n`` steps (K codes each) for every active slot."""
        for _ in range(n):
            self._step_one(generator)
        self._stats["decode_steps"] += n
        self._stats["step_dispatches"] += 1
        for i in range(self.num_slots):
            if self._uids[i] is not None:
                self._remaining[i] = max(0, self._remaining[i] - n)

    @torch.no_grad()
    def _step_one(self, generator: Optional[torch.Generator]) -> None:
        st, k = self.state, self.K
        active, step = st["active"], st["step"]
        logits = self.decode_logits(st["last_ids"])
        kk = torch.arange(k, device=self.device)[None]
        in_window = (step[:, None] >= kk) & (
            step[:, None] < kk + st["num_frames"][:, None])  # (S, K)
        logits = logits + torch.where(in_window[..., None], self._code_mask,
                                      self._pad_only)
        tokens = sample_logits_vec(
            generator, logits.reshape(self.num_slots * k, -1),
            st["temperature"].repeat_interleave(k),
            st["top_k"].repeat_interleave(k),
            st["top_p"].repeat_interleave(k),
            st["do_sample"].repeat_interleave(k),
            max_top_k=self.max_top_k).reshape(self.num_slots, k)

        rows = torch.arange(self.num_slots, device=self.device)
        w_idx = step.clamp(max=self.max_steps - 1).long()
        st["out"][rows, w_idx] = torch.where(active[:, None], tokens,
                                             st["out"][rows, w_idx])
        steps_next = step + 1
        finished = active & (steps_next == st["num_frames"] + k - 1)
        st["step"] = torch.where(active, steps_next, step).int()
        st["last_ids"] = torch.where(active[:, None], tokens,
                                     st["last_ids"]).int()
        st["index"] = torch.where(active, st["index"] + 1, st["index"]).int()
        st["active"] = active & ~finished

    def _undelay(self, uid: int, delayed: np.ndarray,
                 nframes: int) -> UniTokResult:
        """The delay undone on a (max_steps, K) buffer of the host."""
        codes = np.stack([delayed[k:k + nframes, k] for k in range(self.K)],
                         axis=-1)
        return UniTokResult(uid, np.clip(codes, 0,
                                         self.cfg.codebook_size - 1))

    def drain_stashes(self) -> List[UniTokResult]:
        """The codes of displaced slots, every pending stash fetched in one
        device read."""
        if not self._pending_stashes:
            return []
        uids = [u for us, _ in self._pending_stashes for u in us]
        packed = torch.cat([s for _, s in self._pending_stashes]).cpu()
        self._pending_stashes = []
        self._stats["stash_fetches"] += 1
        return self._results(uids, packed.numpy())

    def harvest(self) -> List[UniTokResult]:
        """Results of the slots whose request finished (one device read);
        frees the slots."""
        done = [i for i in range(self.num_slots)
                if self._uids[i] is not None and self._remaining[i] == 0]
        if not done:
            return []
        packed = self._outputs().cpu().numpy()
        results = self._results([self._uids[i] for i in done], packed[done])
        for i in done:
            self._uids[i] = None
            self.allocator.release(self._slot_blocks[i])
            self._slot_blocks[i] = []
            self._done_slots.discard(i)
        return results

    def run(self, requests: List[UniTokRequest],
            generator: Optional[torch.Generator] = None,
            poll_interval: int = 256) -> Dict[int, UniTokResult]:
        """Serve every request: each round admits waves (the pending
        requests of the first one's signature, then of the next) into free
        and finished slots while they last, then decodes to the next
        completion in power-of-two chunks of at most ``poll_interval``
        (floored to a power of two); the stashed codes are drained in one
        read at the end."""
        for r in requests:
            self.validate(r)
        poll_interval = 1 << (max(int(poll_interval), 1).bit_length() - 1)
        self._stats["poll_interval"] = poll_interval
        pending = list(requests)
        results: Dict[int, UniTokResult] = {}
        guard = 0
        while True:
            while pending and self._open_slots():
                sig = self._signature(pending[0])
                admitted = set(self.admit_wave(
                    [r for r in pending if self._signature(r) == sig]))
                if not admitted:
                    break
                pending = [r for r in pending if r.uid not in admitted]
            live = [self._remaining[i] for i in range(self.num_slots)
                    if self._uids[i] is not None and self._remaining[i] > 0]
            if not live:
                if pending:
                    raise RuntimeError("requests cannot be admitted (KV pool "
                                       "too small for any pending request)")
                break
            for c in segment_chunks(min(live), poll_interval):
                self.step(c, generator)
            guard += 1
            if guard > 100000:
                raise RuntimeError("engine did not converge")
        for r in self.drain_stashes():
            results[r.uid] = r
        for r in self.harvest():
            results[r.uid] = r
        return results

    def stats(self) -> Dict[str, float]:
        """Serving counters (host-side) and pool occupancy."""
        out = dict(self._stats)
        out["active_slots"] = sum(
            1 for i in range(self.num_slots)
            if self._uids[i] is not None and self._remaining[i] > 0)
        out["blocks_held"] = sum(len(b) for b in self._slot_blocks)
        out["attention"] = self.use_kernel or "plain"
        return out
