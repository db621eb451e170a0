"""SCP-driven training data pipeline with threaded prefetch.

The port's own copy of ``unified_audio_tpu/data/data_module.py``: kaldi-style
SCP parsing (``WaveInfo``, ``load_scp``), speaker-paired sampling (two
utterances of the target speaker, one of an interfering speaker), a random
task per batch in {se, tse, rtse}, the simulation of
``data/simulation.py``, ``ThreadPoolExecutor`` workers feeding a bounded
queue, and sharding by rank: by the given ``process_index`` /
``process_count`` (under a mesh, its dp coordinate and size:
``parallel/mesh.py dp_shard``), else ``torch.distributed``'s rank when it
is initialized, else rank 0 of 1. ``batch_size`` is per rank, as it is per
process in the JAX package. All draws come from one ``random.Random``
and one ``np.random.Generator``, seeded from ``seed`` and the rank and
shared by the workers, as in the JAX package: with more than one worker,
which sample takes which draw depends on thread timing, so two iterators
of one seed need not agree. Ranks that must train on the same batches
(tp and pp peers) take them from one iterator through
``parallel/mesh.py share_batches``.

Two changes from the JAX package: an error in the producer (a wav that
fails to load three times) reaches the consumer, which raises it, where the
JAX iterator waits forever; and ``Prefetcher`` takes the place of
``DevicePrefetcher``: it stages the next batches in pinned host memory and
copies them to the card with ``non_blocking`` on a side stream while the
current step computes.
"""
from __future__ import annotations

import collections
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils import profiling
from . import simulation
from .audio_io import read_wav

_STOP = object()  # the producer's last item


def _drain_into(q: queue.Queue, stop: threading.Event, items):
    """Put each of ``items`` into ``q``, then ``_STOP``; an exception the
    items raise is put in its place. Gives up when ``stop`` is set (the
    consumer went away)."""
    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in items:
            if not put(item):
                return
        put(_STOP)
    except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
        put(e)


def _consume(q: queue.Queue, stop: threading.Event):
    """Yield the producer's items until ``_STOP``; raise the exception it
    passed on. Closing the generator tells the producer to stop."""
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


@dataclass
class WaveInfo:
    """One SCP line. speech: 'utt spk path'; noise: 'utt fs start frames path';
    rir: 'utt path'."""

    utt: str
    path: str
    spk: str = "unknown"
    fs: Optional[int] = None
    offset: float = 0.0
    duration: Optional[float] = None

    @classmethod
    def parse(cls, line: str, kind: str) -> "WaveInfo":
        parts = line.strip().split(" ")
        if kind == "rir":
            utt, path = parts
            return cls(utt=utt, path=path)
        if kind == "speech":
            utt, spk, path = parts
            return cls(utt=utt, spk=spk, path=path)
        if kind == "noise":
            utt, fs, start, frames, path = parts
            fs = int(float(fs))
            return cls(utt=utt, path=path, fs=fs,
                       offset=float(start) / fs, duration=float(frames) / fs)
        raise ValueError(kind)


def load_scp(scp_paths, kind: str, base_dir: str = "") -> List[WaveInfo]:
    if not isinstance(scp_paths, (list, tuple)):
        scp_paths = [scp_paths]
    out = []
    for p in scp_paths:
        with open(p) as f:
            for line in f:
                if line.strip():
                    info = WaveInfo.parse(line, kind)
                    if base_dir:
                        info.path = str(Path(base_dir) / info.path)
                    out.append(info)
    return out


def pad_or_cut(wav: np.ndarray, length: int, offset: Optional[int],
               rng: random.Random):
    if wav.shape[-1] < length:
        return np.pad(wav, [(0, 0), (0, length - wav.shape[-1])],
                      mode="wrap"), None
    if offset is None:
        offset = rng.randint(0, wav.shape[-1] - length)
    return wav[..., offset : offset + length], offset


def normalize_src_tgt(src, tgt, rng: random.Random, low=0.1, high=0.99):
    max_tgt = np.max(np.abs(tgt)) + 1e-5
    max_src = np.max(np.abs(src)) + 1e-5
    threshold = high / max(max_tgt, max_src)
    target = rng.uniform(low, high)
    factor = min(target / max_tgt, threshold)
    return src * factor, tgt * factor


def data_shard(process_index: Optional[int] = None,
               process_count: Optional[int] = None):
    """-> (index, count) of this rank's share of the data: the given ones;
    else ``torch.distributed``'s rank and world size when it is
    initialized; else (0, 1)."""
    if process_index is not None:
        return process_index, process_count
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def normalize_mix_speech_interf(mix, speech, interf, rng: random.Random,
                                low=0.1, high=0.99):
    a, b, c = (np.max(np.abs(x)) for x in (mix, speech, interf))
    max_v = max(a, b, c) + 1e-5
    min_v = min(a, b, c)
    factor = high / max_v
    if min_v * factor > low:
        factor = rng.uniform(low / (min_v * factor), 1.0) * factor
    return mix * factor, speech * factor, interf * factor


class TrainDataIterator:
    """Yields (mode, enroll, mix, speech, interf, fs, lengths, names) batches
    of host numpy arrays."""

    def __init__(
        self,
        speech_scp: Union[str, Sequence[str]],
        noise_scp: Union[str, Sequence[str]],
        rir_scp: Union[str, Sequence[str]],
        speech_base_dir: str = "",
        batch_size: int = 8,
        cut_duration: Union[float, Sequence[float]] = 5.0,
        enroll_duration: float = 5.0,
        num_workers: int = 4,
        prefetch: int = 2,
        samples_per_epoch: int = 10000,
        simulation_config: Optional[Dict] = None,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.batch_size = batch_size
        self.cut_duration = cut_duration
        self.enroll_duration = enroll_duration
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.samples_per_epoch = samples_per_epoch
        self.sim_config = simulation_config or simulation.DEFAULT_SIM_CONFIG

        self.rank, self.world_size = data_shard(process_index, process_count)
        self.rng = random.Random(seed + 1000 * self.rank)
        self.nprng = np.random.default_rng(seed + 1000 * self.rank)

        self.speech_list = load_scp(speech_scp, "speech", speech_base_dir)
        self.spk2speech = collections.defaultdict(list)
        for info in self.speech_list:
            self.spk2speech[info.spk].append(info)
        self.spk_list = [s for s, v in self.spk2speech.items() if len(v) > 1]
        if len(self.spk_list) < 2:
            raise ValueError("need at least two speakers with >= 2 "
                             "utterances each")
        self.noise_list = load_scp(noise_scp, "noise")
        self.rir_list = load_scp(rir_scp, "rir")

    def _load(self, info: WaveInfo) -> np.ndarray:
        wav, fs = read_wav(info.path)
        wav = wav[:1]
        if info.duration is not None:
            start = int(info.offset * fs)
            end = start + int(info.duration * fs)
            wav = wav[:, start:end]
        return wav

    def _one_sample(self, fs: int, cut_duration: float, mode: str):
        """One simulated sample; its worker thread's CPU seconds are the
        recorder's ``data.loader_cpu_s`` (``utils/profiling.py``)."""
        with profiling.cpu_time("data.loader_cpu_s"):
            return self._simulate(fs, cut_duration, mode)

    def _simulate(self, fs: int, cut_duration: float, mode: str):
        rng = self.rng
        spk1, spk2 = rng.sample(self.spk_list, 2)
        speech_info, enroll_info = rng.sample(self.spk2speech[spk1], 2)
        interf_info = rng.choice(self.spk2speech[spk2])

        for _ in range(3):  # a failed load retries with another utterance
            try:
                speech = self._load(speech_info)
                enroll = interf = None
                if mode in ("tse", "rtse"):
                    enroll = self._load(enroll_info)
                    interf = self._load(interf_info)
                elif rng.random() < self.sim_config["se_interference"]["prob"]:
                    interf = self._load(interf_info)
                break
            except Exception:
                speech_info = rng.choice(self.spk2speech[rng.choice(self.spk_list)])
                continue
        else:
            raise RuntimeError("failed to load speech sample")

        noise = self._load(rng.choice(self.noise_list)) if self.noise_list else None
        rir = self._load(rng.choice(self.rir_list)) if self.rir_list else None

        mix, speech, interf = simulation.simulate_data(
            mode, speech, interf, noise, rir, fs, self.sim_config, self.nprng
        )
        length = int(cut_duration * fs)
        mix, offset = pad_or_cut(mix, length, None, rng)
        speech, _ = pad_or_cut(speech, length, offset, rng)
        if interf is not None:
            interf, _ = pad_or_cut(interf, length, offset, rng)
            mix, speech, interf = normalize_mix_speech_interf(
                mix, speech, interf, rng
            )
        else:
            mix, speech = normalize_src_tgt(mix, speech, rng)
        if enroll is not None:
            enroll, _ = pad_or_cut(enroll, int(self.enroll_duration * fs),
                                   None, rng)
            enroll = enroll / (np.max(np.abs(enroll)) + 1e-5) * 0.99
        return enroll, mix, speech, interf, fs, length, speech_info.utt

    def __len__(self):
        return int(self.samples_per_epoch // (self.world_size * self.batch_size))

    def _batches(self):
        """The epoch's batches, made by ``num_workers`` threads."""
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for _ in range(len(self)):
                fs = 16000
                cut = (
                    self.rng.uniform(*self.cut_duration)
                    if isinstance(self.cut_duration, (list, tuple))
                    else self.cut_duration
                )
                mode = self.rng.choice(["se", "tse", "rtse"])
                results = list(pool.map(
                    self._one_sample,
                    [fs] * self.batch_size, [cut] * self.batch_size,
                    [mode] * self.batch_size,
                ))
                enrolls, mixes, speeches, interfs, fss, lens, names = zip(
                    *results)
                yield (
                    mode,
                    np.concatenate(enrolls, 0).astype(np.float32)
                    if mode != "se" else None,
                    np.concatenate(mixes, 0).astype(np.float32),
                    np.concatenate(speeches, 0).astype(np.float32),
                    np.concatenate(interfs, 0).astype(np.float32)
                    if mode != "se" else None,
                    np.asarray(fss, np.int64),
                    np.asarray(lens, np.int64),
                    list(names),
                )

    def __iter__(self):
        """The epoch's batches, made ahead by a producer thread (at most
        ``prefetch + 1`` waiting). An error in the producer is raised
        here."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch + 1)
        stop = threading.Event()
        threading.Thread(target=_drain_into, args=(q, stop, self._batches()),
                         daemon=True).start()
        return _consume(q, stop)


class Prefetcher:
    """Stages the next ``depth`` batches on ``device`` from a background
    thread while the current step computes: each numpy array of a batch
    becomes a tensor, on a CUDA device pinned in host memory and copied
    with ``non_blocking`` on a side stream; the consumer's stream waits
    for the copy before the batch is handed out. Other fields (the mode,
    the names) pass through. An error in the iterator or the copy is
    raised in the consumer."""

    def __init__(self, iterator, device, depth: int = 2):
        self.iterator = iterator
        self.device = torch.device(device)
        self.depth = depth

    def _staged(self, stream):
        cuda = self.device.type == "cuda"
        for batch in self.iterator:
            with profiling.span("data.stage"):
                out = []
                for x in batch:
                    if isinstance(x, np.ndarray):
                        x = torch.from_numpy(x)
                        if cuda:
                            with torch.cuda.stream(stream):
                                x = x.pin_memory().to(self.device,
                                                      non_blocking=True)
                    out.append(x)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(stream)
            yield tuple(out), event

    def __iter__(self):
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        threading.Thread(target=_drain_into,
                         args=(q, stop, self._staged(stream)),
                         daemon=True).start()
        items = _consume(q, stop)
        try:
            while True:
                with profiling.span("data.wait"):
                    got = next(items, None)
                if got is None:
                    return
                batch, event = got
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for x in batch:
                        if isinstance(x, torch.Tensor):
                            x.record_stream(current)
                yield batch
        finally:
            items.close()  # tells the producer to stop
