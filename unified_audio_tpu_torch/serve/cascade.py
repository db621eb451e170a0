"""The SS (speech separation) cascade served through the continuous-batching
engine.

Port of ``unified_audio_tpu/serve/cascade.py``. The offline flow
(``UniSE.separate_ss``) chains three generates: SE on the first 5-s segment
builds an enrollment, then TSE extracts speaker s1 and rTSE extracts s2
over every segment. :class:`SSCascadeRunner` runs the same chain as engine
requests:

  phase 1   the SE request of every cascade (the first segment, normalized
            by its own peak) runs through the engine with any regular
            traffic.
  bridge    per cascade, on the device: the SE tokens are detokenized,
            flattened and cut to one segment, scaled to a peak of 0.99
            (``max |x| + 1e-5``), and the WavLM frontend turns that exact
            segment into the enrollment rows, a tensor the engine admits as
            it is (it pads them to the bucket itself; features of
            bucket-padded audio would differ under WavLM's global
            attention). The enhanced waveform never reaches the host.
  phase 2   TSE and rTSE requests for every segment (normalized by the
            whole utterance's peak), all pointing at their cascade's rows.

Greedy output is token for token the offline cascade's
(tests/test_torch_cascade.py holds it to the JAX package's).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .engine import ContinuousBatchingEngine, Request, Result

# the phases of a cascade, each also its requests' task id (se, tse, rtse)
_SE, _TSE, _RTSE = 0, 1, 2


@dataclass
class SSRequest:
    """One cascade, built by :meth:`SSCascadeRunner.make`: the SE phase's
    features of the first segment and every segment's mix features, both
    on the WavLM frontend's device."""
    uid: int
    first_feats: torch.Tensor  # (F, D)
    seg_feats: torch.Tensor  # (N, F, D)
    orig_len: int  # samples of the input, for reassembly
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    do_sample: bool = True


@dataclass
class SSResult:
    uid: int
    s1: List[Result] = field(default_factory=list)  # per segment, in order
    s2: List[Result] = field(default_factory=list)


class SSCascadeRunner:
    """Drives SS cascades through ``engine``; ``unise`` supplies the bridge
    models (BiCodec detokenizer, WavLM frontend) and the segment geometry.
    Regular requests ride phase 1 when passed to :meth:`run` as ``extra``."""

    def __init__(self, engine: ContinuousBatchingEngine, unise):
        self.eng = engine
        self.unise = unise
        self.seg_len = unise.config.segment_len
        self.frames = unise._semantic_len()

    @staticmethod
    def _sub_uid(uid: int, phase: int, seg: int) -> int:
        return (uid * 4 + phase) * 65536 + seg

    def make(self, wav: np.ndarray, uid: int, **sampling) -> SSRequest:
        """An :class:`SSRequest` of the (1, T) 16 kHz waveform ``wav``, its
        features normalized as ``separate_ss`` normalizes its inputs: the
        first segment (wrap-padded to one) by its own peak, every segment
        by the utterance's peak."""
        u = self.unise
        wav = np.asarray(wav, np.float32)
        first = wav[:, :self.seg_len]
        if first.shape[-1] < self.seg_len:
            first = np.pad(first, [(0, 0), (0, self.seg_len
                                            - first.shape[-1])], mode="wrap")
        fseg, _ = u._segment(first)
        first_feats = u.extract_semantic_features(
            fseg / np.abs(first).max(axis=-1, keepdims=True))[0]
        segs, t = u._segment(wav)
        seg_feats = u.extract_semantic_features(
            segs / np.abs(wav).max(axis=-1, keepdims=True))
        return SSRequest(uid=uid, first_feats=first_feats,
                         seg_feats=seg_feats, orig_len=t, **sampling)

    def _request(self, r: SSRequest, phase: int, seg: int, mix, enroll=None):
        return Request(
            task_id=phase, mix_feats=mix, enroll_feats=enroll,
            global_length=self.unise.config.global_tokens,
            semantic_length=self.frames, temperature=r.temperature,
            top_k=r.top_k, top_p=r.top_p, do_sample=r.do_sample,
            uid=self._sub_uid(r.uid, phase, seg))

    @torch.no_grad()
    def _enroll_rows(self, se: Result) -> torch.Tensor:
        """The bridge: an SE result's tokens -> enrollment rows (F, D) on
        the frontend's device."""
        tok = self.unise.tokenizer
        dev = tok.model.quantizer.codebook.weight.device
        est = tok.detokenize(
            torch.as_tensor(se.global_ids, device=dev)[None, None],
            torch.as_tensor(se.semantic_ids, device=dev)[None])
        w = est.float().reshape(1, -1)[:, :self.seg_len]
        w = w / (w.abs().max() + 1e-5) * 0.99
        return self.unise.wavlm_feats(w)[0]

    def run(self, requests: List[SSRequest],
            generator: Optional[torch.Generator] = None,
            extra: Optional[List[Request]] = None,
            ) -> Tuple[Dict[int, SSResult], Dict[int, Result]]:
        """Runs the cascades, with ``extra`` riding phase 1 -> (cascade
        results by uid, ``extra``'s results by uid)."""
        se_uids = {self._sub_uid(r.uid, _SE, 0) for r in requests}
        extra = list(extra or [])
        clash = se_uids & {r.uid for r in extra}
        if clash:
            raise ValueError(f"extra request uids {sorted(clash)} collide "
                             "with the cascades' SE requests")
        out1 = self.eng.run([self._request(r, _SE, 0, r.first_feats)
                             for r in requests] + extra, generator)
        phase2 = []
        for r in requests:
            rows = self._enroll_rows(out1[self._sub_uid(r.uid, _SE, 0)])
            for phase in (_TSE, _RTSE):
                phase2 += [self._request(r, phase, i, mix, rows)
                           for i, mix in enumerate(r.seg_feats)]
        out2 = self.eng.run(phase2, generator)
        results = {}
        for r in requests:
            n = r.seg_feats.shape[0]
            results[r.uid] = SSResult(
                r.uid, [out2[self._sub_uid(r.uid, _TSE, i)] for i in range(n)],
                [out2[self._sub_uid(r.uid, _RTSE, i)] for i in range(n)])
        return results, {u: v for u, v in out1.items() if u not in se_uids}

    def assemble(self, r: SSRequest, res: SSResult
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Token results -> (s1, s2) waveforms of the input's length."""
        out = []
        for parts in (res.s1, res.s2):
            g = np.stack([p.global_ids for p in parts])
            s = np.stack([p.semantic_ids for p in parts])
            out.append(self.unise._decode_tokens(g, s, r.orig_len))
        return out[0], out[1]
