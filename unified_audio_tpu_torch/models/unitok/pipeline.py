"""UniTok end to end: audio -> H-Codec codes -> multitask LM -> codes ->
audio.

Port of ``unified_audio_tpu/models/unitok/pipeline.py`` over the port's
HCodec-1.0 tokenizer: the acoustic and semantic RVQ streams interleave on
the codebook axis (acoustic nq, then semantic nq = K codebooks per 25 Hz
frame) and conditioning audio enters as the tokenizer's HuBERT features.
``train_loss`` is the teacher-forced multitask loss (the target's codes
from the frozen tokenizer, K6 on the card), ``generate`` the AR decode.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..hcodec.tokenizer import HCodecTokenizer
from .model import UNITOK_TASKS, UniTokConfig, UniTokLM


class UniTokPipeline:
    def __init__(self, tokenizer: HCodecTokenizer, lm: UniTokLM):
        nq = tokenizer.config.num_quantizers
        if lm.cfg.num_quantizers != nq or lm.cfg.num_streams != 2:
            raise ValueError(f"LM of {lm.cfg.num_streams} streams x "
                             f"{lm.cfg.num_quantizers} quantizers does not "
                             f"fit a codec of 2 x {nq}")
        self.tokenizer = tokenizer
        self.lm = lm

    @classmethod
    def from_random(cls, codec_config=None, ssl_config=None,
                    lm_config: Optional[UniTokConfig] = None, seed: int = 0,
                    device="cuda"):
        """HCodec-1.0 (default the shipped config) with a HuBERT frontend
        (default HuBERT-base) and a UniTok LM (default ``UniTokConfig`` over
        the codec's codebooks), all fp32 on ``device`` with random weights
        from ``seed``. Runs on the card unless ``device="cpu"``."""
        from ...cli import _build_hcodec
        from ...utils.initialization import init_random_

        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; UniTokPipeline "
                               "runs on an NVIDIA card unless device='cpu'")
        tok = _build_hcodec("hcodec10", seed=seed, device=device,
                            cfg=codec_config, ssl_cfg=ssl_config)
        cfg = lm_config or UniTokConfig(
            codebook_size=tok.config.codebook_size,
            num_quantizers=tok.config.num_quantizers)
        with torch.device(device):
            lm = UniTokLM(cfg)
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        return cls(tok, init_random_(lm, gen).eval())

    def audio_to_codes(self, wav):
        """wav (B, T) -> interleaved codes (B, T', 2 * nq)."""
        acoustic, semantic = self.tokenizer.tokenize(wav)  # (B, nq, T')
        return torch.cat([acoustic.transpose(-1, -2),
                          semantic.transpose(-1, -2)], dim=-1)

    def codes_to_audio(self, codes):
        """codes (B, T', 2 * nq) -> wav (B, T' * hop), fp32."""
        nq = self.tokenizer.config.num_quantizers
        return self.tokenizer.detokenize(codes[..., :nq].transpose(-1, -2),
                                         codes[..., nq:].transpose(-1, -2))

    def train_loss(self, task: str, input_wav, target_wav, caption_feats=None,
                   ref_wav=None):
        """Teacher-forced multitask loss -> (loss, acc): conditioned on the
        HuBERT features of ``input_wav`` (B, T) (and of ``ref_wav``), the
        LM predicts the codes of ``target_wav`` (B, T) from the frozen
        tokenizer. The waveforms are moved to the tokenizer's device, the
        card unless the pipeline was built on the CPU; the gradients reach
        the LM only."""
        tok = self.tokenizer
        dev = next(tok.codec.parameters()).device

        def on(x):
            return None if x is None else torch.as_tensor(x).to(
                dev, torch.float32)

        input_wav, target_wav, ref_wav = map(on, (input_wav, target_wav,
                                                  ref_wav))
        codes = self.audio_to_codes(target_wav)
        input_feats = tok.extract_features(input_wav)
        ref_feats = (tok.extract_features(ref_wav) if ref_wav is not None
                     else None)
        return self.lm.loss(UNITOK_TASKS[task], caption_feats, ref_feats,
                            input_feats, codes)

    @torch.no_grad()
    def generate(self, task: str, input_wav, num_frames: Optional[int] = None,
                 caption_feats=None, ref_wav=None, do_sample: bool = True,
                 generator: Optional[torch.Generator] = None):
        """input_wav (B, T) -> generated wav (B, num_frames * hop). The
        number of frames defaults to the input's; ``caption_feats`` (B, Tc,
        text_dim) are given as features (there is no text encoder)."""
        tok = self.tokenizer
        input_feats = tok.extract_features(tok.pad_wav(input_wav))
        if num_frames is None:
            num_frames = input_wav.shape[-1] // tok.hop_length
        ref_feats = (tok.extract_features(ref_wav) if ref_wav is not None
                     else None)
        codes = self.lm.generate(
            UNITOK_TASKS[task], caption_feats, ref_feats, input_feats,
            num_frames, generator, do_sample=do_sample,
            batch=input_wav.shape[0])
        return self.codes_to_audio(codes)
