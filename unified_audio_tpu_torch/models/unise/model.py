"""UniSE: AR-LM speech enhancement on BiCodec tokens (SE / TSE).

Port of ``unified_audio_tpu/models/unise/model.py``: ``UniSEConfig``,
``_segment`` (wrap-pad to 5-s segments), ``_semantic_len``, the WavLM
feature path (the wav padded by 160 samples on each side, all-layer mean),
the log-mel frontend ``stft_logmel``,
``_decode_tokens``, the offline ``enhance_se`` / ``enhance_tse`` /
``separate_ss`` flows over ``LLMSFT.generate``, and the SFT training loss
``loss_fn``. ``serve/cascade.py`` serves the SS cascade through the engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.nn import functional as F

from ...ops import dsp
from ...utils.profiling import span
from ..bicodec.tokenizer import BiCodecTokenizer
from ..lm.llama import LlamaConfig
from ..lm.moonlight import MoonlightConfig
from ..lm.sft import LLMSFT
from ..ssl.wav2vec2 import Wav2Vec2Model, conv_frames, wavlm_features

TASK_MAP = {"se": 0, "tse": 1, "rtse": 2}


@dataclass(frozen=True)
class UniSEConfig:
    sample_rate: int = 16000
    segment_seconds: float = 5.0
    n_fft: int = 640
    hop_length: int = 320
    win_length: int = 640
    n_mels: int = 80
    feats_dim: int = 768  # WavLM hidden
    global_tokens: int = 32  # speaker token count (BiCodec token_num)
    # the LM's stack (lm_config): UniSE's Llama, or Moonlight's
    llm: Union[LlamaConfig, MoonlightConfig] = field(
        default_factory=LlamaConfig)

    @property
    def segment_len(self) -> int:
        return int(self.segment_seconds * self.sample_rate)


def lm_config(section: dict):
    """The LM config of a YAML ``lm`` section: ``backbone: moonlight``
    gives a ``MoonlightConfig`` of the other keys, ``backbone: llama`` (the
    default) a ``LlamaConfig``."""
    kw = dict(section)
    backbone = kw.pop("backbone", "llama")
    kinds = {"llama": LlamaConfig, "moonlight": MoonlightConfig}
    if backbone not in kinds:
        raise ValueError(f"lm backbone {backbone!r}: one of {sorted(kinds)}")
    return kinds[backbone](**kw)


class UniSE:
    """Holds the LM (``LLMSFT``), the WavLM frontend and the BiCodec
    decoder, each already on its device and in its dtype."""

    def __init__(self, config: UniSEConfig, tokenizer: BiCodecTokenizer,
                 wavlm: Wav2Vec2Model, sft: LLMSFT):
        self.config = config
        self.tokenizer = tokenizer
        self.wavlm = wavlm
        self.sft = sft

    # --- feature frontend ---

    @torch.no_grad()
    def wavlm_feats(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, N) waveform -> (B, F, feats_dim) WavLM features."""
        w = self.wavlm.feature_extractor.conv_layers[0].conv.weight
        padded = F.pad(wav.to(w.device, w.dtype), (160, 160))
        return wavlm_features(self.wavlm(padded))

    def wavlm_frames(self, n_samples: int) -> int:
        """Feature frames :meth:`wavlm_feats` makes from ``n_samples``."""
        return conv_frames(self.wavlm.config, n_samples + 320)

    def extract_semantic_features(self, wav) -> torch.Tensor:
        return self.wavlm_feats(torch.as_tensor(np.asarray(wav, np.float32)))

    def stft_logmel(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, N) waveform -> (B, frames, n_mels) log-mel at the config's
        STFT sizes (``ops/dsp.py stft_logmel``), on ``wav``'s device."""
        cfg = self.config
        return dsp.stft_logmel(wav, cfg.n_fft, cfg.hop_length,
                               cfg.win_length, cfg.n_mels, cfg.sample_rate)

    # --- training ---

    def frozen_inputs(self, enroll, mix, target):
        """The frozen half of a training step: the BiCodec tokens of
        ``target`` (XLSR-53 features, the feature encoder, the speaker
        encoder) and the WavLM features of ``mix`` and ``enroll`` (None
        for SE), without gradients, the tokenizer and WavLM in ``.eval()``
        -> (enroll_feats, mix_feats, global_ids (B, G), semantic_ids
        (B, T)). Spans: ``unise.frozen`` around the tokenizer's
        ``bicodec.xlsr`` and ``bicodec.tokenize``, and
        ``unise.frozen.wavlm``."""
        with span("unise.frozen"):
            self.tokenizer.eval()
            self.wavlm.eval()
            global_tokens, semantic_tokens = self.tokenizer.tokenize(target)
            with span("unise.frozen.wavlm"):
                enroll_feats = (self.wavlm_feats(enroll)
                                if enroll is not None else None)
                mix_feats = self.wavlm_feats(mix)
        return enroll_feats, mix_feats, global_tokens[:, 0, :], semantic_tokens

    def loss_fn(self, task: str, enroll, mix, target):
        """Single-task SFT loss -> (loss, acc): tokenization and features
        frozen, the LM as the caller left it (``.train()`` when training).
        For "rtse" the caller passes the interferer as the target. enroll,
        mix, target: (B, N) waveforms on the model's device."""
        enroll_feats, mix_feats, g, s = self.frozen_inputs(enroll, mix,
                                                           target)
        return self.sft(TASK_MAP[task], enroll_feats, mix_feats, g, s)

    # --- inference flows ---

    def _segment(self, wav: np.ndarray) -> Tuple[np.ndarray, int]:
        """Wrap-pad (1, T) to a multiple of the segment length and reshape
        to (N, seg_len)."""
        seg = self.config.segment_len
        t = wav.shape[-1]
        pad = -(-t // seg) * seg - t
        seg_src = np.pad(np.asarray(wav), [(0, 0), (0, pad)], mode="wrap")
        return seg_src.reshape(-1, seg), t

    def _semantic_len(self) -> int:
        cfg = self.config
        return -(-cfg.segment_len // cfg.hop_length)

    def _decode_tokens(self, global_ids, semantic_ids, orig_len: int):
        with span("unise.detokenize", segments=len(global_ids)):
            dev = self.tokenizer.model.quantizer.codebook.weight.device
            est = self.tokenizer.detokenize(
                torch.as_tensor(global_ids, device=dev)[:, None, :],
                torch.as_tensor(semantic_ids, device=dev))
            return est.float().cpu().numpy().reshape(-1)[:orig_len]

    def enhance_se(self, wav: np.ndarray,
                   generator: Optional[torch.Generator] = None,
                   do_sample: bool = False) -> np.ndarray:
        """SE: segment, peak-normalize, generate, detokenize, flatten."""
        seg_src, t = self._segment(wav)
        seg_src = seg_src / np.max(np.abs(wav), axis=-1, keepdims=True)
        mix_feats = self.extract_semantic_features(seg_src)
        g, s = self.sft.generate(
            TASK_MAP["se"], None, mix_feats, generator,
            global_length=self.config.global_tokens,
            semantic_length=self._semantic_len(), do_sample=do_sample)
        return self._decode_tokens(g, s, t)

    def enhance_tse(self, wav: np.ndarray, enroll: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    do_sample: bool = False, task: str = "tse"):
        """TSE (or rTSE): enrollment features broadcast over segments."""
        seg_src, t = self._segment(wav)
        enroll_feats = self.extract_semantic_features(enroll)
        enroll_feats = enroll_feats.expand(seg_src.shape[0],
                                           *enroll_feats.shape[1:])
        mix_feats = self.extract_semantic_features(seg_src)
        g, s = self.sft.generate(
            TASK_MAP[task], enroll_feats, mix_feats, generator,
            global_length=self.config.global_tokens,
            semantic_length=self._semantic_len(), do_sample=do_sample)
        return self._decode_tokens(g, s, t)

    def separate_ss(self, wav: np.ndarray,
                    generator: Optional[torch.Generator] = None,
                    do_sample: bool = False):
        """SS cascade: SE on the first segment (wrap-padded to one segment)
        builds an enrollment, cut to one segment and scaled to a peak of
        0.99; then TSE extracts s1 and rTSE s2 over every segment.
        -> (s1, s2), each (T,)."""
        seg = self.config.segment_len
        first = np.asarray(wav)[:, :seg]
        if first.shape[-1] < seg:
            first = np.pad(first, [(0, 0), (0, seg - first.shape[-1])],
                           mode="wrap")
        enroll = self.enhance_se(first, generator, do_sample)[None, :seg]
        enroll = enroll / (np.max(np.abs(enroll)) + 1e-5) * 0.99
        s1 = self.enhance_tse(wav, enroll, generator, do_sample, task="tse")
        s2 = self.enhance_tse(wav, enroll, generator, do_sample, task="rtse")
        return s1, s2
