"""Token corpus for CodecLM pretraining: wavs tokenized into ``.npz``
shards, and shuffled batches over the shards.

The port's own copy of ``unified_audio_tpu/data/token_corpus.py`` (the
port imports nothing of the JAX package): the same shard format, the same
batches for the same seed. ``tokenize_corpus`` runs the port's BiCodec
tokenizer (``models/bicodec/tokenizer.py``) on the device its model lies
on, the card unless it was built on the CPU.

Shard format: ``.npz`` with two arrays per utterance i, ``global_{i}``
(Ng,) int32 and ``semantic_{i}`` (T_i,) int32. Semantic lengths vary and
are cropped at a random offset, or wrap-padded, to ``semantic_len`` at
batch time (pretraining clips may be cut mid-utterance).
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .audio_io import read_wav as _read_wav


def write_token_shard(path, utterances: Sequence[Tuple[np.ndarray,
                                                       np.ndarray]]):
    """utterances: (global_ids (Ng,), semantic_ids (T,)) pairs."""
    arrays = {}
    for i, (g, s) in enumerate(utterances):
        arrays[f"global_{i}"] = np.asarray(g, np.int32)
        arrays[f"semantic_{i}"] = np.asarray(s, np.int32)
    np.savez_compressed(path, **arrays)


def tokenize_corpus(tokenizer, wav_paths: Sequence, out_dir,
                    utterances_per_shard: int = 256,
                    read_wav=None) -> List[Path]:
    """Tokenize each wav's first channel with ``tokenizer`` (``tokenize(wav
    (1, T)) -> (global (1, 1, Ng), semantic (1, T'))``, the BiCodec
    layout) on the device of its model and write ``tokens_{k:05d}.npz``
    shards of ``utterances_per_shard`` into ``out_dir`` -> the shard
    paths."""
    read_wav = read_wav or _read_wav
    device = next(tokenizer.model.parameters()).device
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shards: List[Path] = []
    buf: List[Tuple[np.ndarray, np.ndarray]] = []

    def flush():
        if not buf:
            return
        p = out_dir / f"tokens_{len(shards):05d}.npz"
        write_token_shard(p, buf)
        shards.append(p)
        buf.clear()

    for wp in wav_paths:
        wav, _ = read_wav(wp)
        g, s = tokenizer.tokenize(torch.as_tensor(wav[:1]).to(device))
        g, s = g.cpu().numpy(), s.cpu().numpy()
        g = g.reshape(-1) if g.ndim <= 2 else g[0, 0]
        buf.append((g.astype(np.int32), s[0].astype(np.int32)))
        if len(buf) >= utterances_per_shard:
            flush()
    flush()
    return shards


def _load_shard(path) -> List[Tuple[np.ndarray, np.ndarray]]:
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("global_"))
        return [(z[f"global_{i}"], z[f"semantic_{i}"]) for i in range(n)]


class TokenCorpusIterator:
    """Shuffled, prefetched pretraining batches over token shards: yields
    (global_ids (B, Ng), semantic_ids (B, semantic_len), None), int32
    numpy, forever (the epochs wrap). Shards are split over processes by
    ``process_index`` / ``process_count``. The draws come from one
    ``numpy.random.default_rng(seed + process_index)`` in the JAX
    package's order, so a seed gives its batches."""

    def __init__(self, shard_paths: Sequence, batch_size: int,
                 semantic_len: int = 250, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 4):
        paths = sorted(str(p) for p in shard_paths)
        self.paths = paths[process_index::process_count]
        if not self.paths:
            raise ValueError("no shards for this process")
        self.batch_size = batch_size
        self.semantic_len = semantic_len
        self.rng = np.random.default_rng(seed + process_index)
        self.prefetch = prefetch

    def _crop(self, s: np.ndarray) -> np.ndarray:
        t = self.semantic_len
        if len(s) >= t:
            off = int(self.rng.integers(0, len(s) - t + 1))
            return s[off:off + t]
        return np.pad(s, (0, t - len(s)), mode="wrap")

    def _batches(self) -> Iterator:
        """Batches of ``batch_size`` utterances of one shard each (a
        shard's remainder is dropped). An epoch that yields none raises
        (the JAX package's loop would spin forever)."""
        while True:
            order = self.rng.permutation(len(self.paths))
            yielded = False
            for si in order:
                utts = _load_shard(self.paths[si])
                self.rng.shuffle(utts)
                for i in range(0, len(utts) - self.batch_size + 1,
                               self.batch_size):
                    chunk = utts[i:i + self.batch_size]
                    g = np.stack([c[0] for c in chunk]).astype(np.int32)
                    s = np.stack([self._crop(c[1]) for c in chunk]).astype(
                        np.int32)
                    yielded = True
                    yield g, s, None
            if not yielded:
                raise ValueError(f"no shard holds {self.batch_size} "
                                 "utterances, a batch")

    def __iter__(self):
        """The batches, made by a producer thread ``prefetch`` ahead; an
        error there is raised here (a dead producer does not hang the
        consumer)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for item in self._batches():
                    if not put(("batch", item)):
                        return
            except Exception as e:  # raised again by the consumer
                put(("error", e))

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "error":
                    raise item
                yield item
        finally:
            stop.set()
