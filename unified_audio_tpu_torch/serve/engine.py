"""Continuous-batching decode engine for UniSE serving over a paged KV pool.

Port of ``unified_audio_tpu/serve/engine.py`` (``ContinuousBatchingEngine``,
``Request``, ``Result``, ``segment_chunks``). A fixed set of S slots shares
one block pool (``serve/paged.py``):

* ``prestage`` packs the inputs of a wave into one host buffer per
  admission signature (pinned on the card) and starts their host-to-device
  copies on a side stream; on the wire a waveform travels as int16 samples
  and host features as the engine's dtype or as int8 rows with a
  per-frame power-of-two exponent (``feats_wire``).
* ``admit_many`` takes requests into slots in waves. Each wave groups
  requests by signature (the kind and bucket of the mix and of the
  enrollment), decodes the wire on the device, runs the WavLM frontend for
  waveform inputs at each waveform's exact length, assembles the prompts
  padded to the buckets, compacts the real tokens to the left (so positions
  and cache layout match the unpadded prompt), prefills the wave in one
  batch and scatters the prefilled K/V into each slot's blocks. A slot
  whose request finished but was not harvested is reused without a device
  read: its outputs are copied into a device-side stash before the insert
  overwrites them, and ``drain_stashes`` fetches every pending stash in
  one read.
* ``step(n)`` advances every active slot by ``n`` tokens: the paged decode
  step, per-request sampling (``sample_logits_vec``: greedy rows take the
  argmax, so one step serves greedy and sampled traffic alike) and the
  phase machine (global_length + 1 global steps, the last discarded but
  cached, then semantic_length semantic steps). Finished rows are masked
  out of every write, so a step past a slot's end changes nothing of it.
* ``harvest`` returns finished requests and frees their slots (one device
  read); ``cancel`` drops an in-flight request; ``run`` drives displacing
  admission, chunked steps to each completion and the stash drains until
  every request is done.

Decode lengths are fixed, so the host knows when each slot finishes and
reads device state only to fetch outputs. A step reads no device value and
writes every tensor in place, so on a CUDA device it is captured once as a
CUDA graph (per pool bound and generator) and replayed: one graph launch a
step instead of the ~650 kernel launches of its eager dispatch.
Enroll-less requests ride the widest enroll bucket of their mix's kind
with their enroll rows compacted out, so mixed SE/TSE/rTSE traffic shares
one prefill per wave.

The attention mode is chosen once, from the device of the model: the owner
kernels (``"owner"``, contiguous regions from a ``RegionAllocator``) on
CUDA, the plain attention (``""``) on the CPU. ``"stream"`` (the stream
kernels over a ``BlockAllocator``'s scattered blocks) is the mode of a pool
shared with another engine: pass the same ``pool_ref`` and ``allocator``
to both (``serve/unitok_engine.py`` serves UniTok from the same pool).
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.lm.llama import range_mask, sample_logits_vec
from ..models.lm.sft import LLMSFT
from ..utils.profiling import count, held, release, span
from .paged import (TRASH_BLOCK, PoolRef, kernel_mode, open_pool,
                    paged_decode_ids, pool_blocks, scatter_cache)

PHASE_GLOBAL, PHASE_SEMANTIC, PHASE_DONE = 0, 1, 2
MAX_TOP_K = 256  # the widest per-request top_k (one static topk per step)
FEATS_WIRES = ("bf16", "int8")


def graph_steps_on(device: torch.device, lm) -> bool:
    """Whether an engine over ``lm`` on ``device`` replays its decode steps
    as CUDA graphs: on a CUDA device, unless ``lm`` is cut under tensor
    parallelism (a rank then holds fewer heads than the config, and its
    step holds collectives)."""
    return (device.type == "cuda"
            and lm.layers[0].self_attn.local_heads == lm.cfg.num_heads)


@dataclass
class Request:
    """One serving request: the mix as SSL features (``mix_feats`` (T, D),
    a numpy array, or a tensor on the engine's device taken as it is), as a
    16 kHz waveform (``mix_wav`` (N,), engines built with ``feature_fn`` and
    ``wav_buckets``) or as rows already on the device (``mix_device_frames``
    frames, the rows handed over by :meth:`ContinuousBatchingEngine.
    stage_request`); an optional enrollment the same ways."""
    task_id: int
    mix_feats: Optional[Union[np.ndarray, torch.Tensor]] = None
    enroll_feats: Optional[Union[np.ndarray, torch.Tensor]] = None
    mix_wav: Optional[np.ndarray] = None
    enroll_wav: Optional[np.ndarray] = None
    mix_device_frames: Optional[int] = None
    enroll_device_frames: Optional[int] = None
    global_length: int = 32
    semantic_length: int = 250
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    do_sample: bool = True
    uid: int = 0

    @property
    def is_wav(self) -> bool:
        return self.mix_wav is not None


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


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _quantize_feats_row(x: np.ndarray) -> np.ndarray:
    """(F, D) float features -> (F, D+1) int8 wire row: symmetric int8 with
    a per-frame power-of-two scale stored as an exponent in the last
    column (half the bytes of bf16 rows, one buffer, no side scales)."""
    x = np.asarray(x, np.float32)
    m = np.abs(x).max(axis=-1)
    e = np.ceil(np.log2(np.maximum(m, 1e-30) / 127.0))
    e = np.clip(e, -100.0, 100.0)
    q = np.clip(np.rint(x * np.exp2(-e)[:, None]), -127, 127)
    return np.concatenate([q, e[:, None]], axis=-1).astype(np.int8)


def _dequant_feats(rows: torch.Tensor, dtype) -> torch.Tensor:
    """int8 wire rows (..., F, D+1) -> (..., F, D) features: q * 2^e, e the
    last column. Zero rows (padding) carry e = 0, q = 0 -> exact zeros."""
    q = rows[..., :-1].float()
    return (q * torch.exp2(rows[..., -1:].float())).to(dtype)


def _to_wire(wav: np.ndarray) -> np.ndarray:
    """Host-side cast of a waveform to the int16 wire, rounded to the
    nearest LSB (a peak of exactly 1.0 becomes 32767/32768)."""
    return np.clip(np.rint(np.asarray(wav, np.float32) * 32768.0),
                   -32768, 32767).astype(np.int16)


def h2d(array, device: torch.device) -> torch.Tensor:
    """A small host array (metadata, indices) on ``device``, copied without
    waiting for the work queued on the card (a blocking copy from pageable
    memory would wait for it)."""
    t = torch.as_tensor(np.asarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def segment_chunks(remaining: int, poll_interval: int) -> List[int]:
    """A decode segment of ``remaining`` steps as power-of-two chunks of at
    most ``poll_interval`` (a power of two), largest first: one step call
    a chunk, none past the segment. (The JAX engine may round the last
    chunk up, its ``dispatch_overshoot``: there a chunk is one compiled
    program, while each step of this engine is its own launch, eager or a
    graph replay, so an overshot step would cost a real step and save no
    dispatch.)"""
    chunks: List[int] = []
    while remaining > 0:
        c = min(poll_interval, 1 << (remaining.bit_length() - 1))
        chunks.append(c)
        remaining -= c
    return chunks


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
        wav_buckets: Optional[Sequence[int]] = None,
        feats_wire: str = "bf16",
        pool_ref: Optional[PoolRef] = None,
        allocator=None,
    ):
        """``sft`` is the LM, already on its device and in its serving
        dtype (the pool and activations follow it).

        ``mix_buckets`` are the feature-frame lengths prompts pad to (mix
        and enrollment alike). ``feature_fn(wav (B, N) tensor) -> (B, F,
        D)`` and ``frames_fn(n_samples) -> F`` enable waveform requests,
        whose lengths must fit ``wav_buckets``: a sample bucket caps a
        waveform and keys its wave, and its frame count joins the frame
        buckets. The frontend runs on each waveform at its exact length
        (the JAX engine runs it on the bucket-padded audio, which under
        WavLM's global attention gives other features unless the waveform
        fills its bucket).

        Waveforms cross to the device as int16 samples; host features as
        the engine's dtype (``feats_wire="bf16"``) or as int8 rows with a
        per-frame power-of-two exponent, dequantized on the device
        (``"int8"``). Feature tensors already on the engine's device skip
        the wire.

        ``use_kernel`` overrides the attention mode that is otherwise
        chosen from the device ("owner" on CUDA, "" on CPU); "stream" is
        the third. ``kv_quant="int8"`` stores the pool as int8 with
        per-token scales. ``pool_ref`` and ``allocator`` (given together)
        share another engine's pool; its storage format then decides
        ``kv_quant``."""
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
        if feats_wire not in FEATS_WIRES:
            raise ValueError(f"feats_wire {feats_wire!r} not in "
                             f"{FEATS_WIRES}")
        if (feature_fn is None) != (frames_fn is None):
            raise ValueError("feature_fn and frames_fn go together")
        if wav_buckets and feature_fn is None:
            raise ValueError("wav_buckets requires feature_fn")
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_global = max_global
        self.max_semantic = max_semantic
        self.feature_fn = feature_fn
        self.frames_fn = frames_fn
        self.feats_wire = feats_wire
        self.wav_buckets = tuple(sorted(wav_buckets or ()))
        # the frame counts of the sample buckets join the frame buckets, so
        # prompt assembly and table sizing see the waveforms' lengths
        self.buckets = tuple(sorted(
            set(mix_buckets) | {frames_fn(b) for b in self.wav_buckets}))

        # table width: enough logical blocks for the largest request
        max_prompt = 3 + 2 * self.buckets[-1]
        max_tokens = max_prompt + max_global + 1 + max_semantic + 1
        self.max_blocks = math.ceil(max_tokens / block_size)
        self._pool_ref, self.allocator, self.kv_quant = open_pool(
            cfg, num_slots, self.max_blocks, block_size, self.use_kernel,
            self.kv_dtype, self.device, kv_quant, pool_ref=pool_ref,
            allocator=allocator)
        self.num_blocks = pool_blocks(self.pool)

        # host-side mirrors: decode lengths are fixed, so the host knows
        # when each slot finishes without reading the device
        self._slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
        self._uids: List[Optional[int]] = [None] * num_slots
        self._remaining: List[int] = [0] * num_slots
        # finished slots whose blocks are released but whose outputs are
        # still in the state (displaceable), and the stashes of displaced
        # slots not yet fetched: (uids, (n, G + T + 2) int32 on the device)
        self._done_slots: set = set()
        self._pending_stashes: List[tuple] = []
        # uid -> (mix ref, enroll ref or None); a ref is (tensor, row) with
        # row None when the tensor itself is the input
        self._staged: Dict[int, tuple] = {}
        # host-to-device copies in flight on the card: (event, host buffer,
        # device buffer); the host buffer lives until its event completes
        self._copies: List[tuple] = []
        self._copy_stream = None

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
        # (nb, generator) -> None after the key's first (eager) step, then
        # (its captured step, {counter or kernel wrapper: count a step})
        self._graphs: Dict[tuple, Optional[tuple]] = {}
        self._graphed = graph_steps_on(self.device, sft)
        self._stats = {"requests_admitted": 0, "requests_completed": 0,
                       "requests_cancelled": 0, "tokens_generated": 0,
                       "decode_steps": 0, "step_dispatches": 0,
                       "prefill_waves": 0, "stash_fetches": 0,
                       "graph_captures": 0, "graph_replays": 0,
                       "t_prestage": 0.0, "t_admit": 0.0, "t_step": 0.0,
                       "t_drain": 0.0, "t_harvest": 0.0}

    @property
    def pool(self) -> Dict[str, torch.Tensor]:
        return self._pool_ref.pool

    @contextlib.contextmanager
    def _clock(self, key: str):
        """Add the block's host seconds to ``stats()[key]``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stats[key] += time.perf_counter() - t0

    # --- requests ---

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
        n_mix = sum(x is not None for x in
                    (req.mix_wav, req.mix_feats, req.mix_device_frames))
        if n_mix != 1:
            raise ValueError("request needs exactly one of mix_wav / "
                             f"mix_feats / mix_device_frames, got {n_mix}")
        if sum(x is not None for x in (req.enroll_wav, req.enroll_feats,
                                       req.enroll_device_frames)) > 1:
            raise ValueError("request has more than one of enroll_wav / "
                             "enroll_feats / enroll_device_frames")
        for feats in (req.mix_feats, req.enroll_feats):
            if torch.is_tensor(feats) and feats.device != self.device:
                raise ValueError(f"feature tensor on {feats.device}, the "
                                 f"engine on {self.device}")
        if (req.mix_device_frames is not None
                or req.enroll_device_frames is not None) \
                and self.feats_wire != "bf16":
            raise ValueError("device-staged inputs need feats_wire='bf16' "
                             "(their rows are features in the engine's "
                             "dtype)")
        if (req.mix_wav is not None or req.enroll_wav is not None) \
                and not self.wav_buckets:
            raise ValueError("waveform request needs an engine built with "
                             "feature_fn, frames_fn and wav_buckets")
        self._signature(req)  # raises on an input longer than its buckets

    def _mix_frames(self, req: Request) -> int:
        if req.is_wav:
            return self.frames_fn(req.mix_wav.shape[-1])
        if req.mix_device_frames is not None:
            return req.mix_device_frames
        return req.mix_feats.shape[0]

    def _enroll_frames(self, req: Request) -> Optional[int]:
        if req.enroll_wav is not None:
            return self.frames_fn(req.enroll_wav.shape[-1])
        if req.enroll_feats is not None:
            return req.enroll_feats.shape[0]
        return req.enroll_device_frames

    def _signature(self, req: Request):
        """Wave key ``(mix kind, mix bucket, enroll kind, enroll bucket)``:
        kind "w" (a waveform, its sample bucket) or "f" (features, their
        frame bucket). Enroll-less requests join the widest enroll bucket
        of their mix's kind (their enroll rows compact out)."""
        if req.is_wav:
            mk, mix_b = "w", _pick_bucket(req.mix_wav.shape[-1],
                                          self.wav_buckets, "mix_wav")
        else:
            mk, mix_b = "f", _pick_bucket(self._mix_frames(req),
                                          self.buckets, "mix")
        if req.enroll_wav is not None:
            ek, enr_b = "w", _pick_bucket(req.enroll_wav.shape[-1],
                                          self.wav_buckets, "enroll_wav")
        elif self._enroll_frames(req) is not None:
            ek, enr_b = "f", _pick_bucket(self._enroll_frames(req),
                                          self.buckets, "enroll")
        elif mk == "w":
            ek, enr_b = "w", self.wav_buckets[-1]
        else:
            ek, enr_b = "f", self.buckets[-1]
        return mk, mix_b, ek, enr_b

    def _frame_bucket(self, kind: str, bucket: int) -> int:
        return self.frames_fn(bucket) if kind == "w" else bucket

    # --- staging ---

    def _resident(self, x) -> bool:
        """A feature tensor already on the engine's device skips the wire."""
        return torch.is_tensor(x) and x.device == self.device

    def _row_spec(self, kind: str, bucket: int):
        """(row shape, dtype) of a staged input of ``kind``."""
        if kind == "w":
            return (bucket,), torch.int16
        if self.feats_wire == "int8":
            return (bucket, self.sft.feats_dim + 1), torch.int8
        return (bucket, self.sft.feats_dim), self.kv_dtype

    def _fill_row(self, buf: torch.Tensor, row: int, kind: str, data):
        if kind == "w":
            wire = _to_wire(data)
            buf[row, :wire.shape[-1]] = torch.from_numpy(wire)
        elif self.feats_wire == "int8":
            q = _quantize_feats_row(np.asarray(data))
            buf[row, :q.shape[0]] = torch.from_numpy(q)
        else:  # cast on assignment
            x = torch.as_tensor(np.asarray(data, np.float32))
            buf[row, :x.shape[0]] = x

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        """The host buffer on the engine's device. On the card the copy runs
        on a side stream (``non_blocking`` from pinned memory) and overlaps
        the decode the main stream is running; admission waits on its
        event (:meth:`_await_copies`)."""
        if self.device.type != "cuda":
            return host
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._copies.append((event, host, dev))
        return dev

    def _await_copies(self) -> None:
        """Make the current stream wait for every staging copy issued so far
        (a device-side wait, no host sync); drop the host buffers whose
        copies have completed."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        live = []
        for event, host, dev in self._copies:
            if dev is not None:
                stream.wait_event(event)
                dev.record_stream(stream)  # allocated on the side stream
            if not event.query():
                live.append((event, host, None))
        self._copies = live

    def _stage(self, reqs: List[Request]) -> None:
        """Stage ``reqs``' inputs: per signature, one host buffer of the mix
        rows and one of the enroll rows (row counts rounded up to powers of
        two), filled in the wire's dtype and copied to the device."""
        groups: Dict[tuple, List[Request]] = {}
        for r in reqs:
            if r.mix_device_frames is not None \
                    or r.enroll_device_frames is not None:
                raise ValueError(
                    f"request {r.uid} declares device-staged inputs but was "
                    "never staged: call stage_request(req, mix_ref, "
                    "enroll_ref) before admission")
            groups.setdefault(self._signature(r), []).append(r)
        pin = self.device.type == "cuda"
        for (mk, mix_b, ek, enr_b), group in groups.items():
            refs = {r.uid: [None, None] for r in group}
            for slot, kind, bucket, attr in ((0, mk, mix_b, "mix"),
                                             (1, ek, enr_b, "enroll")):
                host_rows = []
                for r in group:
                    data = (getattr(r, f"{attr}_wav") if kind == "w"
                            else getattr(r, f"{attr}_feats"))
                    if data is None:
                        continue
                    if self._resident(data):
                        refs[r.uid][slot] = (data, None)
                    else:
                        host_rows.append((r, data))
                if not host_rows:
                    continue
                shape, dtype = self._row_spec(kind, bucket)
                host = torch.zeros((_next_pow2(len(host_rows)),) + shape,
                                   dtype=dtype, pin_memory=pin)
                for i, (_, data) in enumerate(host_rows):
                    self._fill_row(host, i, kind, data)
                dev = self._upload(host)
                for i, (r, _) in enumerate(host_rows):
                    refs[r.uid][slot] = (dev, i)
            for r in group:
                self._staged[r.uid] = tuple(refs[r.uid])

    def prestage(self, reqs: List[Request]) -> None:
        """Start the host-to-device copies of the next wave (the first
        ``num_slots`` of ``reqs`` not yet staged) while earlier decode steps
        run; ``admit_many`` then gathers their rows on the device."""
        with self._clock("t_prestage"), span("engine.prestage"):
            todo = [r for r in reqs[:self.num_slots]
                    if r.uid not in self._staged]
            if todo:
                self._stage(todo)

    def stage_request(self, req: Request, mix_ref=None,
                      enroll_ref=None) -> None:
        """Stage ``req`` from buffers on the device. ``mix_ref`` and
        ``enroll_ref`` are ``(buffer, row)`` pairs whose rows are
        (bucket, feats_dim) features in the engine's dtype, zero past the
        true frame count (``req.mix_device_frames`` /
        ``enroll_device_frames``), ``bucket`` one of the engine's frame
        buckets; the rows never cross the host link. Without ``mix_ref``
        the mix, and a host enrollment without ``enroll_ref``, are staged
        from the host as :meth:`prestage` would."""
        self.validate(req)
        if mix_ref is None and req.mix_device_frames is not None:
            raise ValueError("mix_device_frames set but no mix_ref supplied")
        if enroll_ref is None and req.enroll_device_frames is not None:
            raise ValueError("enroll_device_frames set but no enroll_ref "
                             "supplied")
        if mix_ref is None:
            self._stage([replace(req, enroll_device_frames=None)])
            mix_ref, host_enroll = self._staged.pop(req.uid)
            enroll_ref = host_enroll if enroll_ref is None else enroll_ref
        elif enroll_ref is None and (req.enroll_wav is not None
                                     or req.enroll_feats is not None):
            raise ValueError("a mix on the device needs its enrollment on "
                             "the device too (enroll_ref)")
        self._staged[req.uid] = (mix_ref, enroll_ref)

    def _wave_inputs(self, kind: str, bucket: int, wave: List[Request],
                     refs: List, attr: str) -> torch.Tensor:
        """(B, frames, D) zero-padded features of one input (``attr`` "mix"
        or "enroll") of a wave from its staged refs: rows gathered from
        each staging buffer in one index, the int8 wire dequantized,
        waveforms decoded from the wire and run through the frontend at
        their exact lengths, batched by length."""
        fb = self._frame_bucket(kind, bucket)
        out = torch.zeros((len(wave), fb, self.sft.feats_dim),
                          dtype=self.kv_dtype, device=self.device)
        by_buf: Dict[int, tuple] = {}
        for pos, ref in enumerate(refs):
            if ref is None:
                continue
            buf, row = ref
            if row is None:  # the tensor is the input
                n = min(buf.shape[0], fb)
                out[pos, :n] = buf[:n].to(self.kv_dtype)
                continue
            by_buf.setdefault(id(buf), (buf, [], []))
            by_buf[id(buf)][1].append(pos)
            by_buf[id(buf)][2].append(row)
        for buf, pos, rows in by_buf.values():
            x = buf[h2d(np.asarray(rows, np.int64), self.device)]
            if kind == "w":
                wavs = x.float() * (1.0 / 32768.0)  # the int16 wire
                by_len: Dict[int, List[int]] = {}
                for j, p in enumerate(pos):
                    n = getattr(wave[p], f"{attr}_wav").shape[-1]
                    by_len.setdefault(n, []).append(j)
                for n, js in by_len.items():
                    feats = self.feature_fn(wavs[js, :n])
                    out[[pos[j] for j in js], :feats.shape[1]] = feats.to(
                        self.kv_dtype)
                continue
            if x.dtype == torch.int8:
                x = _dequant_feats(x, self.kv_dtype)
            n = min(x.shape[1], fb)
            out[pos, :n] = x[:, :n].to(self.kv_dtype)
        return out

    # --- admission ---

    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if self._uids[i] is None]

    def _reap_host(self) -> None:
        """Slots whose request finished (host-known: the fixed lengths) give
        their blocks back and become displaceable; their outputs stay in
        the state until a displacing insert stashes them."""
        for s in range(self.num_slots):
            if (self._uids[s] is not None and self._remaining[s] == 0
                    and s not in self._done_slots):
                self._done_slots.add(s)
                self.allocator.release(self._slot_blocks[s])
                self._slot_blocks[s] = []

    def _outputs(self, rows=None) -> torch.Tensor:
        """(n, G + T + 2) int32: each slot's (or ``rows``') global and
        semantic outputs and their lengths, packed for one device read."""
        st = self.state
        parts = [st["out_global"], st["out_semantic"],
                 st["global_len"][:, None], st["semantic_len"][:, None]]
        if rows is not None:
            parts = [p[rows] for p in parts]
        return torch.cat(parts, dim=1)

    def _results(self, uids, packed: np.ndarray) -> List[Result]:
        g, s = self.max_global, self.max_semantic
        out = [Result(uid, row[:row[g + s]].copy(),
                      row[g:g + row[g + s + 1]].copy())
               for uid, row in zip(uids, packed)]
        self._stats["requests_completed"] += len(out)
        self._stats["tokens_generated"] += sum(
            len(r.global_ids) + 1 + len(r.semantic_ids) for r in out)
        return out

    def admit(self, req: Request) -> bool:
        """Admit one request (:meth:`admit_many`); True if it got a slot.
        Sampling draws come from the generator given to :meth:`step`."""
        return bool(self.admit_many([req]))

    @torch.no_grad()
    def admit_many(self, reqs: List[Request]) -> List[int]:
        """Admit as many requests as slots and pool blocks allow; returns
        the uids admitted. A slot whose request finished but was not
        harvested is reused without a device read; its outputs go to a
        device-side stash first (:meth:`drain_stashes`)."""
        with self._clock("t_admit"), span("engine.admit") as sp:
            waves = self._stats["prefill_waves"]
            admitted = self._admit_waves(reqs)
            sp.note(admitted=len(admitted),
                    waves=self._stats["prefill_waves"] - waves)
        return admitted

    def _admit_waves(self, reqs: List[Request]) -> List[int]:
        for r in reqs:
            self.validate(r)
        self._reap_host()
        free = [i for i in range(self.num_slots)
                if self._uids[i] is None or i in self._done_slots]
        groups: Dict[tuple, List[Request]] = {}
        for r in reqs[:len(free)]:
            groups.setdefault(self._signature(r), []).append(r)

        cfg, bs, dev = self.cfg, self.block_size, self.device
        admitted: List[int] = []
        for (mk, mix_b, ek, enr_b), group in groups.items():
            mix_fb = self._frame_bucket(mk, mix_b)
            enr_fb = self._frame_bucket(ek, enr_b)
            # padded prompt: task, enroll_sos, enroll, mix_sos, mix
            la = 3 + enr_fb + mix_fb
            budget = len(self.allocator.free)
            fitting = []  # (request, blocks needed, true prompt length)
            for r in group:
                enr = self._enroll_frames(r)
                true_total = (2 + self._mix_frames(r)
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
            with span("engine.admit.stage"):
                self._stage([r for r in wave if r.uid not in self._staged])
                refs = [self._staged.pop(r.uid) for r in wave]
                self._await_copies()
            b = len(wave)
            tables = np.full((b, self.max_blocks), TRASH_BLOCK, np.int32)
            # per-row metadata in two transfers: slot, task, n_head,
            # true_total, glen, slen, top_k, do_sample / temperature, top_p
            meta_i = np.zeros((b, 8), np.int32)
            meta_f = np.zeros((b, 2), np.float32)
            displaced_slots, displaced_uids = [], []
            for i, (r, n_blk, true_total) in enumerate(fitting):
                slot = free.pop(0)
                if slot in self._done_slots:
                    displaced_slots.append(slot)
                    displaced_uids.append(self._uids[slot])
                    self._done_slots.discard(slot)
                blocks = self.allocator.alloc(n_blk)
                self._slot_blocks[slot] = blocks
                self._uids[slot] = r.uid
                self._remaining[slot] = r.global_length + 1 + r.semantic_length
                tables[i, :n_blk] = blocks
                enr = self._enroll_frames(r)
                # real head: task alone, or task + enroll_sos + enroll
                meta_i[i] = (slot, r.task_id, 1 if enr is None else 2 + enr,
                             true_total, r.global_length, r.semantic_length,
                             r.top_k, int(r.do_sample))
                meta_f[i] = (r.temperature, r.top_p)
                admitted.append(r.uid)

            with span("engine.admit.frontend"):
                mix = self._wave_inputs(mk, mix_b, wave,
                                        [m for m, _ in refs], "mix")
                enroll = self._wave_inputs(ek, enr_b, wave,
                                           [e for _, e in refs], "enroll")
            with span("engine.admit.prefill"):
                meta = h2d(meta_i, dev)
                prompt = self.sft.prompt(meta[:, 1], enroll, mix)  # (B, la, D)
                # compact the real tokens left: the enroll padding sits
                # between the enroll and mix segments
                t = torch.arange(la, device=dev)[None]
                head = meta[:, 2:3]
                src = torch.where(t < head, t, t - head + 2 + enr_fb)
                prompt = torch.gather(prompt, 1, src.clamp(0, la - 1)[
                    ..., None].expand_as(prompt))
                cache = self.sft.init_cache(b, la, dtype=self.kv_dtype,
                                            device=dev)
                self.sft.prefill(prompt, cache)
            with span("engine.admit.scatter"):
                tables_dev = h2d(tables, dev)
                scatter_cache(self.pool, tables_dev, cache, bs)
                st = self.state
                if displaced_slots:
                    self._pending_stashes.append((
                        displaced_uids, self._outputs(h2d(np.asarray(
                            displaced_slots, np.int64), dev))))
                rows = meta[:, 0].long()
                mf = h2d(meta_f, dev)
                st["block_tables"][rows] = tables_dev
                st["index"][rows] = meta[:, 3]
                st["phase"][rows] = PHASE_GLOBAL
                st["steps_in_phase"][rows] = 0
                st["global_len"][rows] = meta[:, 4]
                st["semantic_len"][rows] = meta[:, 5]
                st["last_ids"][rows] = cfg.global_sos
                st["do_sample"][rows] = meta[:, 7] != 0
                st["temperature"][rows] = mf[:, 0]
                st["top_k"][rows] = meta[:, 6]
                st["top_p"][rows] = mf[:, 1]
                st["out_global"][rows] = 0
                st["out_semantic"][rows] = 0
            self._stats["prefill_waves"] += 1
        self._stats["requests_admitted"] += len(admitted)
        return admitted

    def cancel(self, uid: int) -> bool:
        """Cancel request ``uid``: its staged inputs are dropped and, if it
        holds a slot, the slot's blocks are released and its phase is set
        to done on the device at once (it then writes only to the trash
        block). Returns whether the request held a slot."""
        self._staged.pop(uid, None)
        for s in range(self.num_slots):
            if self._uids[s] == uid:
                self.allocator.release(self._slot_blocks[s])
                self._slot_blocks[s] = []
                self._uids[s] = None
                self._remaining[s] = 0
                self._done_slots.discard(s)
                self.state["phase"][s] = PHASE_DONE
                self._stats["requests_cancelled"] += 1
                return True
        return False

    def drain_stashes(self) -> List[Result]:
        """The outputs of displaced slots, every pending stash fetched in
        one device read."""
        with self._clock("t_drain"), span("engine.drain"):
            if not self._pending_stashes:
                return []
            uids = [u for us, _ in self._pending_stashes for u in us]
            packed = torch.cat([s for _, s in self._pending_stashes]).cpu()
            self._pending_stashes = []
            self._stats["stash_fetches"] += 1
            return self._results(uids, packed.numpy())

    # --- decode ---

    def _block_bound(self) -> int:
        """Pool prefix the plain and stream attention read (the allocator's
        high water, bucketed; with a shared allocator it covers every
        engine's blocks); the owner kernels read each slot's own region."""
        if self.use_kernel == "owner":
            return self.num_blocks
        return self.allocator.bounded_high_water()

    @torch.no_grad()
    def _step_one(self, generator, nb: int) -> None:
        cfg, st = self.cfg, self.state
        phase = st["phase"]
        active = phase != PHASE_DONE
        with span("engine.step.lm"):
            logits = paged_decode_ids(
                cfg, self.sft, self.pool, st["block_tables"], st["index"],
                active, st["last_ids"], self.block_size,
                num_active_blocks=nb, use_kernel=self.use_kernel)
        in_global = phase == PHASE_GLOBAL
        in_semantic = phase == PHASE_SEMANTIC
        with span("engine.step.sample"):
            mask = torch.where(in_global[:, None], self._gmask, self._smask)
            tokens = sample_logits_vec(
                generator, logits + mask, st["temperature"], st["top_k"],
                st["top_p"], st["do_sample"], max_top_k=MAX_TOP_K)
        with span("engine.step.update"):
            steps = st["steps_in_phase"]
            rows = torch.arange(self.num_slots, device=self.device)
            # global phase emits global_len + 1 tokens; the last is
            # discarded (but cached), so only steps < global_len are stored
            write_g = in_global & (steps < st["global_len"]) & active
            g_idx = steps.clamp(max=self.max_global - 1).long()
            st["out_global"][rows, g_idx] = torch.where(
                write_g, tokens - cfg.global_offset,
                st["out_global"][rows, g_idx])
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
            # in place: a captured step reads and writes the same storage
            # at every replay
            st["last_ids"].copy_(torch.where(active, next_ids,
                                             st["last_ids"]))
            st["phase"].copy_(torch.where(active, new_phase, phase))
            st["steps_in_phase"].copy_(torch.where(active, new_steps, steps))
            st["index"].copy_(torch.where(active, st["index"] + 1,
                                          st["index"]))

    def _capture(self, generator, nb: int) -> tuple:
        """One :meth:`_step_one` captured as a CUDA graph -> (graph,
        {counter or kernel wrapper: count a step}). Capture runs nothing,
        so the program counters and kernel launches its Python made are
        held back (``utils/profiling.py held``); each replay releases them
        again."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:  # capture registers the default one
            # each replay advances the generator's offset: fresh draws
            graph.register_generator_state(generator)
        with held() as counts, torch.cuda.graph(graph):
            self._step_one(generator, nb)
        self._stats["graph_captures"] += 1
        return graph, counts

    def _replay(self, n: int, generator, nb: int) -> None:
        """``n`` steps as replays of the key's captured step. The key's
        first step runs eagerly: it warms up what capture cannot do (the
        cuBLAS handles, the kernels' shared-memory opt-in); the capture
        follows at its next step."""
        key = (nb, generator)
        if key not in self._graphs:
            self._step_one(generator, nb)
            self._graphs[key] = None
            n -= 1
        if n == 0:
            return
        if self._graphs[key] is None:
            self._graphs[key] = self._capture(generator, nb)
        graph, counts = self._graphs[key]
        for _ in range(n):
            graph.replay()
        release(counts, n)
        self._stats["graph_replays"] += n
        count("engine.graph_steps", n)

    def step(self, n: int = 1, generator: Optional[torch.Generator] = None,
             nb: Optional[int] = None) -> None:
        """Decode ``n`` tokens for every active slot. ``nb`` overrides the
        pool prefix the plain and stream attention read (default the
        allocator's bucketed high water); the call records it as
        ``stats()["last_nb"]``. Where :func:`graph_steps_on` holds (a CUDA
        device, the LM not cut under tensor parallelism) the steps are
        replays of a CUDA graph captured per ``(nb, generator)``
        (``stats()["graph_captures"|"graph_replays"]``)."""
        with self._clock("t_step"), span("engine.step", n=n):
            nb = self._block_bound() if nb is None else nb
            self._stats["last_nb"] = nb
            if self._graphed:
                self._replay(n, generator, nb)
            else:
                for _ in range(n):
                    self._step_one(generator, nb)
            self._stats["decode_steps"] += n
            self._stats["step_dispatches"] += 1
            for i in range(self.num_slots):
                if self._uids[i] is not None:
                    self._remaining[i] = max(0, self._remaining[i] - n)

    def harvest(self) -> List[Result]:
        """Results of the slots whose request finished (one device read);
        frees the slots."""
        with self._clock("t_harvest"), span("engine.harvest"):
            done = [i for i in range(self.num_slots)
                    if self._uids[i] is not None and self._remaining[i] == 0]
            if not done:
                return []
            packed = self._outputs().cpu().numpy()
            out = self._results([self._uids[i] for i in done], packed[done])
            for i in done:
                self._uids[i] = None
                self.allocator.release(self._slot_blocks[i])
                self._slot_blocks[i] = []
                self._done_slots.discard(i)
            return out

    def run(self, requests: List[Request],
            generator: Optional[torch.Generator] = None,
            poll_interval: int = 256) -> Dict[int, Result]:
        """Serve every request: displacing admission into finished slots
        (no device read between waves), decode to the next completion in
        power-of-two chunks of at most ``poll_interval`` (floored to a
        power of two), the next wave's inputs staged during the first
        chunk, and the stashed outputs drained in one read at the end.
        The host seconds of each call are in ``stats()["t_prestage"|
        "t_admit"|"t_step"|"t_drain"|"t_harvest"]``, whoever calls
        :meth:`prestage`, :meth:`admit_many`, :meth:`step`,
        :meth:`drain_stashes` and :meth:`harvest` (the drain and harvest
        reads include waiting for the decode); with the recorder of
        ``utils/profiling.py`` on, each call is also an ``engine.*``
        span."""
        poll_interval = 1 << (max(int(poll_interval), 1).bit_length() - 1)
        self._stats["poll_interval"] = poll_interval
        try:
            return self._run(list(requests), generator, poll_interval)
        finally:
            # staged inputs of requests that were never admitted
            held = set(self._uids)
            self._staged = {u: v for u, v in self._staged.items()
                            if u in held}

    def _run(self, pending, generator, poll_interval):
        results: Dict[int, Result] = {}
        if pending:
            self.prestage(pending)
        guard = 0
        while True:
            if pending:
                admitted = set(self.admit_many(pending))
                pending = [r for r in pending if r.uid not in admitted]
            live = [self._remaining[i] for i in range(self.num_slots)
                    if self._uids[i] is not None and self._remaining[i] > 0]
            if not live:
                if pending:
                    raise RuntimeError("requests cannot be admitted (KV pool "
                                       "too small for any pending request)")
                break
            for j, c in enumerate(segment_chunks(min(live), poll_interval)):
                self.step(c, generator)
                if j == 0 and pending:
                    # the next wave's copies overlap the first chunk
                    self.prestage(pending)
            guard += 1
            if guard > 400000:
                raise RuntimeError("engine did not converge")
        for r in self.drain_stashes():
            results[r.uid] = r
        for r in self.harvest():
            results[r.uid] = r
        return results

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
