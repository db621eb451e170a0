"""Continuous-batching decode engine for UniSE serving over a paged KV pool.

Port of the core of ``unified_audio_tpu/serve/engine.py``
(``ContinuousBatchingEngine``, ``Request``, ``Result``). A fixed set of S
slots shares one block pool (``serve/paged.py``):

* ``admit_many`` takes requests into free slots in waves. Each wave groups
  requests by (mix bucket, enroll bucket), runs the WavLM frontend on the
  device for waveform inputs, assembles the prompts padded to the buckets,
  compacts the real tokens to the left (so positions and cache layout match
  the unpadded prompt), prefills the wave in one batch and scatters the
  prefilled K/V into each slot's blocks.
* ``step`` advances every active slot by one token: the paged decode step,
  per-request sampling (``sample_logits_vec``: greedy rows take the argmax,
  so one step program serves greedy and sampled traffic alike) and the
  phase machine (global_length + 1 global steps, the last discarded but
  cached, then semantic_length semantic steps).
* ``harvest`` returns finished requests and frees their slots; ``run``
  drives admission, steps and harvests until every request is done.

Decode lengths are fixed, so the host knows when each slot finishes and
reads device state only at those points. Enroll-less requests ride the
widest enroll bucket with their enroll rows compacted out, so mixed
SE/TSE/rTSE traffic shares one prefill per wave.

The attention mode is chosen once, from the device of the model: the owner
kernels (``"owner"``, contiguous regions from a ``RegionAllocator``) on
CUDA, the plain attention (``""``) on the CPU. ``"stream"`` (the stream
kernels over a ``BlockAllocator``'s scattered blocks) is the mode of a pool
shared with another engine: pass the same ``pool_ref`` and ``allocator``
to both (``serve/unitok_engine.py`` serves UniTok from the same pool).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.lm.llama import init_cache, range_mask, sample_logits_vec
from ..models.lm.sft import LLMSFT
from .paged import (TRASH_BLOCK, PoolRef, kernel_mode, open_pool,
                    paged_decode_ids, scatter_prefill)

PHASE_GLOBAL, PHASE_SEMANTIC, PHASE_DONE = 0, 1, 2
MAX_TOP_K = 256  # the widest per-request top_k (one static topk per step)


@dataclass
class Request:
    """One serving request: the mix as SSL features (``mix_feats`` (T, D),
    a numpy array or a tensor on the engine's device, taken as it is) or as
    a 16 kHz waveform (``mix_wav`` (N,), engines built with
    ``feature_fn``); an optional enrollment the same way."""
    task_id: int
    mix_feats: Optional[Union[np.ndarray, torch.Tensor]] = None
    enroll_feats: Optional[Union[np.ndarray, torch.Tensor]] = None
    mix_wav: Optional[np.ndarray] = None
    enroll_wav: Optional[np.ndarray] = None
    global_length: int = 32
    semantic_length: int = 250
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    do_sample: bool = True
    uid: int = 0


@dataclass
class Result:
    uid: int
    global_ids: np.ndarray
    semantic_ids: np.ndarray


def _pick_bucket(n: int, buckets: Sequence[int], what: str) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{what} length {n} exceeds largest bucket {buckets[-1]}")


class ContinuousBatchingEngine:
    """Slot-pool continuous batching over a paged KV block pool."""

    def __init__(
        self,
        sft: LLMSFT,
        num_slots: int = 8,
        block_size: int = 64,
        max_global: int = 32,
        max_semantic: int = 256,
        mix_buckets: Sequence[int] = (64, 128, 256, 320),
        kv_quant: Optional[str] = None,
        use_kernel: Optional[str] = None,
        feature_fn: Optional[Callable] = None,
        frames_fn: Optional[Callable[[int], int]] = None,
        pool_ref: Optional[PoolRef] = None,
        allocator=None,
    ):
        """``sft`` is the LM, already on its device and in its serving
        dtype (the pool and activations follow it). ``feature_fn(wav (B, N)
        tensor) -> (B, F, D)`` and ``frames_fn(n_samples) -> F`` enable
        waveform requests; ``mix_buckets`` are the feature-frame lengths
        prompts pad to (mix and enroll alike). ``use_kernel`` overrides the
        attention mode that is otherwise chosen from the device ("owner" on
        CUDA, "" on CPU); "stream" is the third. ``kv_quant="int8"`` stores
        the pool as int8 with per-token scales. ``pool_ref`` and
        ``allocator`` (given together) share another engine's pool; its
        storage format then decides ``kv_quant``."""
        self.sft = sft
        self.cfg = cfg = sft.cfg
        weight = sft.codec_embedding.weight
        self.device = weight.device
        self.kv_dtype = weight.dtype
        self.use_kernel = kernel_mode(use_kernel, self.device)
        if num_slots > block_size:
            raise ValueError(f"num_slots {num_slots} > block_size "
                             f"{block_size}: inactive slots need distinct "
                             "trash-block offsets")
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_global = max_global
        self.max_semantic = max_semantic
        self.buckets = tuple(sorted(mix_buckets))
        if (feature_fn is None) != (frames_fn is None):
            raise ValueError("feature_fn and frames_fn go together")
        self.feature_fn = feature_fn
        self.frames_fn = frames_fn

        # table width: enough logical blocks for the largest request
        max_prompt = 3 + 2 * self.buckets[-1]
        max_tokens = max_prompt + max_global + 1 + max_semantic + 1
        self.max_blocks = math.ceil(max_tokens / block_size)
        self._pool_ref, self.allocator, self.kv_quant = open_pool(
            cfg, num_slots, self.max_blocks, block_size, self.use_kernel,
            self.kv_dtype, self.device, kv_quant, pool_ref=pool_ref,
            allocator=allocator)
        self.num_blocks = self.pool["k"].shape[1]

        # host-side mirrors: decode lengths are fixed, so the host knows
        # when each slot finishes without reading the device
        self._slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
        self._uids: List[Optional[int]] = [None] * num_slots
        self._remaining: List[int] = [0] * num_slots

        s, dev = num_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.state = {
            "phase": torch.full((s,), PHASE_DONE, **i32),
            "steps_in_phase": torch.zeros((s,), **i32),
            "global_len": torch.zeros((s,), **i32),
            "semantic_len": torch.zeros((s,), **i32),
            "last_ids": torch.zeros((s,), **i32),
            "do_sample": torch.zeros((s,), dtype=torch.bool, device=dev),
            "temperature": torch.ones((s,), device=dev),
            "top_k": torch.ones((s,), **i32),
            "top_p": torch.ones((s,), device=dev),
            "index": torch.zeros((s,), **i32),
            "block_tables": torch.full((s, self.max_blocks), TRASH_BLOCK,
                                       **i32),
            "out_global": torch.zeros((s, max_global), **i32),
            "out_semantic": torch.zeros((s, max_semantic), **i32),
        }
        self._gmask = range_mask(cfg, cfg.global_offset, cfg.global_size, dev)
        self._smask = range_mask(cfg, cfg.semantic_offset, cfg.semantic_size,
                                 dev)
        self._stats = {"requests_admitted": 0, "requests_completed": 0,
                       "tokens_generated": 0, "decode_steps": 0,
                       "prefill_waves": 0}

    @property
    def pool(self) -> Dict[str, torch.Tensor]:
        return self._pool_ref.pool

    # --- admission ---

    def validate(self, req: Request) -> None:
        """Reject requests that can never run under the engine's caps."""
        if not 1 <= req.global_length <= self.max_global:
            raise ValueError(f"global_length {req.global_length} not in "
                             f"[1, {self.max_global}]")
        if not 1 <= req.semantic_length <= self.max_semantic:
            raise ValueError(f"semantic_length {req.semantic_length} not in "
                             f"[1, {self.max_semantic}]")
        if req.temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {req.temperature}")
        if not 0 < req.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {req.top_p}")
        if not 1 <= req.top_k <= MAX_TOP_K:
            raise ValueError(f"top_k {req.top_k} not in [1, {MAX_TOP_K}]")
        if (req.mix_wav is None) == (req.mix_feats is None):
            raise ValueError("request needs exactly one of mix_wav / "
                             "mix_feats")
        if req.enroll_wav is not None and req.enroll_feats is not None:
            raise ValueError("request has both enroll_wav and enroll_feats")
        for feats in (req.mix_feats, req.enroll_feats):
            if torch.is_tensor(feats) and feats.device != self.device:
                raise ValueError(f"feature tensor on {feats.device}, the "
                                 f"engine on {self.device}")
        if (req.mix_wav is not None or req.enroll_wav is not None) \
                and self.feature_fn is None:
            raise ValueError("waveform request needs an engine built with "
                             "feature_fn")
        _pick_bucket(self._frames(req.mix_wav, req.mix_feats),
                     self.buckets, "mix")
        enr = self._frames(req.enroll_wav, req.enroll_feats)
        if enr is not None:
            _pick_bucket(enr, self.buckets, "enroll")

    def _frames(self, wav, feats) -> Optional[int]:
        if wav is not None:
            return self.frames_fn(wav.shape[-1])
        return None if feats is None else feats.shape[0]

    def _signature(self, req: Request):
        """Wave key (mix bucket, enroll bucket); enroll-less requests join
        the widest enroll bucket (their enroll rows compact out)."""
        mix_b = _pick_bucket(self._frames(req.mix_wav, req.mix_feats),
                             self.buckets, "mix")
        enr = self._frames(req.enroll_wav, req.enroll_feats)
        enr_b = (self.buckets[-1] if enr is None
                 else _pick_bucket(enr, self.buckets, "enroll"))
        return mix_b, enr_b

    def _wave_feats(self, reqs: List[Request], kind: str, bucket: int):
        """(B, bucket, D) zero-padded features for one input kind ("mix" or
        "enroll") of a wave; waveforms go through the frontend, batched
        over inputs of equal length."""
        out = torch.zeros((len(reqs), bucket, self.sft.feats_dim),
                          dtype=self.kv_dtype, device=self.device)
        by_len: Dict[int, List[int]] = {}
        for i, r in enumerate(reqs):
            wav = getattr(r, f"{kind}_wav")
            feats = getattr(r, f"{kind}_feats")
            if wav is not None:
                by_len.setdefault(wav.shape[-1], []).append(i)
            elif feats is not None:  # a device tensor is copied on the card
                out[i, :feats.shape[0]] = torch.as_tensor(
                    feats, device=self.device).to(self.kv_dtype)
        for rows in by_len.values():
            wavs = np.stack([getattr(reqs[i], f"{kind}_wav") for i in rows])
            feats = self.feature_fn(torch.as_tensor(
                wavs, dtype=torch.float32, device=self.device))
            out[rows, :feats.shape[1]] = feats.to(self.kv_dtype)
        return out

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if self._uids[i] is None]

    @torch.no_grad()
    def admit_many(self, reqs: List[Request]) -> List[int]:
        """Admit as many requests as free slots and pool blocks allow;
        returns the uids admitted."""
        for r in reqs:
            self.validate(r)
        free = self.free_slots()
        groups: Dict[tuple, List[Request]] = {}
        for r in reqs[:len(free)]:
            groups.setdefault(self._signature(r), []).append(r)

        cfg, bs, dev = self.cfg, self.block_size, self.device
        admitted: List[int] = []
        for (mix_b, enr_b), group in groups.items():
            la = 3 + mix_b + enr_b  # padded prompt: task, sos, enroll, sos, mix
            budget = len(self.allocator.free)
            fitting = []  # (request, blocks needed, true prompt length)
            for r in group:
                enr = self._frames(r.enroll_wav, r.enroll_feats)
                true_total = (2 + self._frames(r.mix_wav, r.mix_feats)
                              + (0 if enr is None else 1 + enr))
                need = max(la, true_total + r.global_length + 1
                           + r.semantic_length)
                n_blk = math.ceil(need / bs)
                cost = self.allocator.block_cost(n_blk)
                if cost <= budget:
                    fitting.append((r, n_blk, true_total))
                    budget -= cost
            if not fitting:
                continue
            wave = [r for r, _, _ in fitting]
            b = len(wave)
            tables = np.full((b, self.max_blocks), TRASH_BLOCK, np.int32)
            slots, n_head, true_len = [], [], []
            for i, (r, n_blk, true_total) in enumerate(fitting):
                slot = free.pop(0)
                blocks = self.allocator.alloc(n_blk)
                self._slot_blocks[slot] = blocks
                self._uids[slot] = r.uid
                self._remaining[slot] = r.global_length + 1 + r.semantic_length
                tables[i, :n_blk] = blocks
                slots.append(slot)
                enr = self._frames(r.enroll_wav, r.enroll_feats)
                # real head: task alone, or task + enroll_sos + enroll
                n_head.append(1 if enr is None else 2 + enr)
                true_len.append(true_total)
                admitted.append(r.uid)

            mix = self._wave_feats(wave, "mix", mix_b)
            enroll = self._wave_feats(wave, "enroll", enr_b)
            task_ids = torch.tensor([r.task_id for r in wave], device=dev)
            prompt = self.sft.prompt(task_ids, enroll, mix)  # (B, la, D)
            # compact the real tokens left: the enroll padding sits between
            # the enroll and mix segments
            t = torch.arange(la, device=dev)[None]
            head = torch.tensor(n_head, device=dev)[:, None]
            src = torch.where(t < head, t, t - head + 2 + enr_b).clamp(0, la - 1)
            prompt = torch.gather(prompt, 1,
                                  src[..., None].expand_as(prompt))
            cache = init_cache(cfg, b, la, dtype=self.kv_dtype, device=dev)
            self.sft.prefill(prompt, cache)
            tables_dev = torch.as_tensor(tables, device=dev)
            scatter_prefill(self.pool, tables_dev, cache["k"], cache["v"], bs)

            st = self.state
            rows = torch.tensor(slots, device=dev)

            def put(name, vals):
                st[name][rows] = torch.as_tensor(
                    vals, device=dev).to(st[name].dtype)

            put("block_tables", tables_dev)
            put("index", true_len)
            put("phase", [PHASE_GLOBAL] * b)
            put("steps_in_phase", [0] * b)
            put("global_len", [r.global_length for r in wave])
            put("semantic_len", [r.semantic_length for r in wave])
            put("last_ids", [cfg.global_sos] * b)
            put("do_sample", [bool(r.do_sample) for r in wave])
            put("temperature", [r.temperature for r in wave])
            put("top_k", [r.top_k for r in wave])
            put("top_p", [r.top_p for r in wave])
            st["out_global"][rows] = 0
            st["out_semantic"][rows] = 0
            self._stats["prefill_waves"] += 1
        self._stats["requests_admitted"] += len(admitted)
        return admitted

    # --- decode ---

    def _block_bound(self) -> int:
        """Pool prefix the plain and stream attention read (the allocator's
        high water, bucketed; with a shared allocator it covers every
        engine's blocks); the owner kernels read each slot's own region."""
        if self.use_kernel == "owner":
            return self.num_blocks
        return self.allocator.bounded_high_water()

    @torch.no_grad()
    def step(self, generator: Optional[torch.Generator] = None) -> None:
        """Decode one token for every active slot."""
        cfg, st = self.cfg, self.state
        phase = st["phase"]
        active = phase != PHASE_DONE
        logits = paged_decode_ids(
            cfg, self.sft, self.pool, st["block_tables"], st["index"], active,
            st["last_ids"], self.block_size,
            num_active_blocks=self._block_bound(), use_kernel=self.use_kernel)
        in_global = phase == PHASE_GLOBAL
        in_semantic = phase == PHASE_SEMANTIC
        mask = torch.where(in_global[:, None], self._gmask, self._smask)
        tokens = sample_logits_vec(
            generator, logits + mask, st["temperature"], st["top_k"],
            st["top_p"], st["do_sample"], max_top_k=MAX_TOP_K)

        steps = st["steps_in_phase"]
        rows = torch.arange(self.num_slots, device=self.device)
        # global phase emits global_len + 1 tokens; the last is discarded
        # (but cached), so only steps < global_len are stored
        write_g = in_global & (steps < st["global_len"]) & active
        g_idx = steps.clamp(max=self.max_global - 1).long()
        st["out_global"][rows, g_idx] = torch.where(
            write_g, tokens - cfg.global_offset, st["out_global"][rows, g_idx])
        write_s = in_semantic & active
        s_idx = steps.clamp(max=self.max_semantic - 1).long()
        st["out_semantic"][rows, s_idx] = torch.where(
            write_s, tokens - cfg.semantic_offset,
            st["out_semantic"][rows, s_idx])

        steps_next = steps + 1
        finish_global = in_global & (steps_next == st["global_len"] + 1)
        finish_semantic = in_semantic & (steps_next == st["semantic_len"])
        new_phase = torch.where(finish_global, PHASE_SEMANTIC, phase)
        new_phase = torch.where(finish_semantic, PHASE_DONE, new_phase)
        new_steps = torch.where(finish_global, 0, steps_next)
        # the semantic phase starts from semantic SOS
        next_ids = torch.where(finish_global, cfg.semantic_sos, tokens)
        st["last_ids"] = torch.where(active, next_ids, st["last_ids"]).int()
        st["phase"] = torch.where(active, new_phase, phase).int()
        st["steps_in_phase"] = torch.where(active, new_steps, steps).int()
        st["index"] = torch.where(active, st["index"] + 1, st["index"]).int()
        self._stats["decode_steps"] += 1
        for i in range(self.num_slots):
            if self._uids[i] is not None:
                self._remaining[i] = max(0, self._remaining[i] - 1)

    def harvest(self) -> List[Result]:
        """Results of the slots whose request finished; frees the slots."""
        done = [i for i in range(self.num_slots)
                if self._uids[i] is not None and self._remaining[i] == 0]
        if not done:
            return []
        st = self.state
        g = st["out_global"].cpu().numpy()
        s = st["out_semantic"].cpu().numpy()
        glen = st["global_len"].cpu().numpy()
        slen = st["semantic_len"].cpu().numpy()
        out = []
        for i in done:
            out.append(Result(self._uids[i], g[i, :glen[i]].copy(),
                              s[i, :slen[i]].copy()))
            self._uids[i] = None
            self.allocator.release(self._slot_blocks[i])
            self._slot_blocks[i] = []
        self._stats["requests_completed"] += len(out)
        self._stats["tokens_generated"] += sum(
            len(r.global_ids) + 1 + len(r.semantic_ids) for r in out)
        return out

    def run(self, requests: List[Request],
            generator: Optional[torch.Generator] = None) -> Dict[int, Result]:
        """Serve every request: admit into free slots, decode to the next
        completion, harvest, repeat."""
        pending = list(requests)
        results: Dict[int, Result] = {}
        while True:
            for r in self.harvest():
                results[r.uid] = r
            if pending:
                admitted = set(self.admit_many(pending))
                pending = [r for r in pending if r.uid not in admitted]
            live = [self._remaining[i] for i in range(self.num_slots)
                    if self._uids[i] is not None and self._remaining[i] > 0]
            if not live:
                if pending:
                    raise RuntimeError("requests cannot be admitted (KV pool "
                                       "too small for any pending request)")
                return results
            for _ in range(min(live)):
                self.step(generator)

    def stats(self) -> Dict[str, float]:
        """Serving counters (host-side) and pool occupancy."""
        held = sum(len(b) for b in self._slot_blocks)
        out = dict(self._stats)
        out["active_slots"] = sum(
            1 for i in range(self.num_slots)
            if self._uids[i] is not None and self._remaining[i] > 0)
        out["blocks_held"] = held
        out["pool_utilization"] = held / max(1, self.num_blocks - 1)
        out["attention"] = self.use_kernel or "plain"
        return out
