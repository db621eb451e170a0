"""Domain-weighted data of codec training: each batch draws a domain
(speech, music, audio, ...) by the configured weights and fills itself
with fixed-length crops of that domain's wavs; a validation iterator
cycles the domains in turn.

Port of ``unified_audio_tpu/data/hcodec_data.py`` (``DomainWeightedIterator``,
``RoundRobinValIterator``) over the port's own ``load_scp`` and
``pad_or_cut``. The draws come from one ``random.Random`` seeded from
``seed`` and the rank (as ``data_module.data_shard`` decides: under a
mesh, pass its dp coordinate and size; ``batch_size`` is per rank), shared
by the ``num_workers`` threads, as in the JAX package: with one worker the
batches are the JAX package's, with more which crop takes which draw
depends on thread timing. One change: an
error in the producer (a domain whose wavs fail to load three times)
reaches the consumer, which raises it, where the JAX iterator waits
forever.
"""
from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from .audio_io import read_wav
from .data_module import (_consume, _drain_into, data_shard, load_scp,
                          pad_or_cut)


class DomainWeightedIterator:
    """Yields (wav (B, T) float32, domain) batches, T = cut_seconds x
    sample_rate. ``domain_scps`` maps a domain to its SCP lists ('utt spk
    path' lines)."""

    def __init__(
        self,
        domain_scps: Dict[str, Sequence[str]],
        domain_weights: Optional[Dict[str, float]] = None,
        batch_size: int = 8,
        cut_seconds: float = 3.0,
        sample_rate: int = 16000,
        num_workers: int = 4,
        prefetch: int = 2,
        samples_per_epoch: int = 10000,
        seed: int = 0,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.lists = {d: load_scp(scps, "speech")
                      for d, scps in domain_scps.items()}
        for d, lst in self.lists.items():
            if not lst:
                raise ValueError(f"empty domain {d}")
        weights = domain_weights or {d: 1.0 for d in self.lists}
        total = sum(weights.values())
        self.domains = list(self.lists)
        self.probs = [weights[d] / total for d in self.domains]
        self.batch_size = batch_size
        self.crop = int(cut_seconds * sample_rate)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.samples_per_epoch = samples_per_epoch
        self.rank, self.world = data_shard(process_index, process_count)
        self.rng = random.Random(seed + 1000 * self.rank)

    def __len__(self):
        return self.samples_per_epoch // (self.world * self.batch_size)

    def _one(self, domain: str) -> np.ndarray:
        """One (1, crop) crop of a random wav of ``domain``; a wav that
        fails to load is replaced by another, three tries in all."""
        rng = self.rng
        for _ in range(3):
            try:
                info = rng.choice(self.lists[domain])
                wav, _ = read_wav(info.path)
                wav, _ = pad_or_cut(wav[:1], self.crop, None, rng)
                return wav
            except Exception:
                continue
        raise RuntimeError(f"failed to load from domain {domain}")

    def _batches(self):
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for _ in range(len(self)):
                domain = self.rng.choices(self.domains,
                                          weights=self.probs)[0]
                wavs = list(pool.map(self._one,
                                     [domain] * self.batch_size))
                yield np.concatenate(wavs, 0).astype(np.float32), domain

    def __iter__(self):
        """The epoch's batches, made ahead by a producer thread (at most
        ``prefetch + 1`` waiting). An error in the producer is raised
        here."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch + 1)
        stop = threading.Event()
        threading.Thread(target=_drain_into, args=(q, stop, self._batches()),
                         daemon=True).start()
        return _consume(q, stop)


class RoundRobinValIterator:
    """Validation: ``limit_per_domain`` rounds over the domains in order,
    the i-th wav of each (cycling its list) cut from its start -> (wav (1,
    T) float32, domain)."""

    def __init__(self, domain_scps: Dict[str, Sequence[str]],
                 cut_seconds: float = 3.0, sample_rate: int = 16000,
                 limit_per_domain: int = 8):
        self.lists = {d: load_scp(s, "speech")
                      for d, s in domain_scps.items()}
        self.crop = int(cut_seconds * sample_rate)
        self.limit = limit_per_domain

    def __iter__(self):
        rng = random.Random(0)
        for i in range(self.limit):
            for d, lst in self.lists.items():
                wav, _ = read_wav(lst[i % len(lst)].path)
                wav, _ = pad_or_cut(wav[:1], self.crop, 0, rng)
                yield wav.astype(np.float32), d
