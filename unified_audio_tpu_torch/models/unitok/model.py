"""UniTok-audio: multitask AR audio generation over interleaved acoustic and
semantic H-Codec codes with a delay pattern.

Port of ``unified_audio_tpu/models/unitok/model.py``: ``UNITOK_TASKS``,
``UniTokConfig`` and ``UniTokLM`` with ``build_prompt``, ``embed_codes``, the
teacher-forced training ``loss`` (JAX's ``UniTokLM.__call__``) and the solo
``generate`` over a dense KV cache. The prompt is
``[T task][C][caption][R][reference audio][I][input audio][S]`` (absent
conditions skipped); K = 2 * nq codebooks (acoustic nq, then semantic nq)
enter as the sum of their embeddings and leave through K parallel heads,
one decode step per 25 Hz frame, codebook k delayed by k steps
(``delay.py``).

State-dict keys: ``backbone.layers.{i}.*`` and ``backbone.norm.weight`` (the
reference torch layout of the decoder stack), ``task_embedding``,
``sep_embedding``, ``text_adapter``, ``audio_adapter``,
``code_embeddings.{k}`` and ``heads.{k}`` (``utils/convert.py
unitok_state_dict`` writes them from the JAX variables).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..lm.llama import (NEG_INF, LlamaBackbone, LlamaConfig, init_cache,
                        sample_logits)
from .delay import apply_delay, undo_delay

UNITOK_TASKS: Dict[str, int] = {
    "sr": 0, "tse": 1, "ss": 2, "vc": 3, "lass": 4, "codec": 5, "ae": 6,
}


@dataclass(frozen=True)
class UniTokConfig:
    codebook_size: int = 1024
    num_quantizers: int = 4  # per stream
    num_streams: int = 2  # acoustic + semantic
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    text_dim: int = 768
    audio_dim: int = 768
    num_tasks: int = len(UNITOK_TASKS)
    max_positions: int = 4096

    @property
    def num_codebooks(self) -> int:
        return self.num_streams * self.num_quantizers

    # per-codebook vocabulary: codes + BOS + PAD (delay hole) + EOS
    @property
    def bos(self) -> int:
        return self.codebook_size

    @property
    def pad(self) -> int:
        return self.codebook_size + 1

    @property
    def eos(self) -> int:
        return self.codebook_size + 2

    @property
    def layer_vocab(self) -> int:
        return self.codebook_size + 3

    @property
    def llama_config(self) -> LlamaConfig:
        """The backbone's geometry, shared by the LM and the paged engine."""
        return LlamaConfig(hidden_size=self.hidden_size,
                           num_layers=self.num_layers,
                           num_heads=self.num_heads,
                           max_position_embeddings=self.max_positions)


def delay_window_masks(cfg: UniTokConfig, device=None):
    """Additive (V,) fp32 masks: ``code`` keeps the real codes (inside the
    delay window), ``pad`` keeps only PAD (outside it)."""
    vocab = torch.arange(cfg.layer_vocab, device=device)
    code = torch.where(vocab < cfg.codebook_size, 0.0, NEG_INF)
    pad = torch.where(vocab == cfg.pad, 0.0, NEG_INF)
    return code, pad


class UniTokLM(nn.Module):
    def __init__(self, cfg: UniTokConfig = UniTokConfig()):
        super().__init__()
        self.cfg = cfg
        self.lcfg = cfg.llama_config
        d = cfg.hidden_size
        self.backbone = LlamaBackbone(self.lcfg)
        self.task_embedding = nn.Embedding(cfg.num_tasks, d)
        # separator tokens [C], [R], [I], [S] (rows 0..3)
        self.sep_embedding = nn.Embedding(4, d)
        self.text_adapter = nn.Linear(cfg.text_dim, d)
        self.audio_adapter = nn.Linear(cfg.audio_dim, d)
        self.code_embeddings = nn.ModuleList(
            [nn.Embedding(cfg.layer_vocab, d)
             for _ in range(cfg.num_codebooks)])
        self.heads = nn.ModuleList(
            [nn.Linear(d, cfg.layer_vocab, bias=False)
             for _ in range(cfg.num_codebooks)])

    def embed_codes(self, codes):
        """codes (..., K) -> the sum of their K embeddings (..., D), in
        codebook order."""
        codes = codes.long()
        out = self.code_embeddings[0](codes[..., 0])
        for k in range(1, self.cfg.num_codebooks):
            out = out + self.code_embeddings[k](codes[..., k])
        return out

    def build_prompt(self, task_id, caption_feats, ref_audio_feats,
                     input_audio_feats, batch: int):
        """[T][C][caption][R][ref audio][I][input audio][S] -> (B, La, D);
        absent conditions are skipped. ``task_id`` is one int for the batch
        or a (B,) tensor (each row its own task); features are (B, T, dim)
        and are cast to the adapters' dtype."""
        w = self.audio_adapter.weight
        d = self.cfg.hidden_size
        task_ids = torch.as_tensor(task_id, device=w.device).long()
        if task_ids.dim() == 0:
            task_ids = task_ids.expand(batch)
        parts = [self.task_embedding(task_ids.view(batch, 1))]

        def sep(i):
            return self.sep_embedding.weight[i].expand(batch, 1, d)

        for i, feats, adapter in ((0, caption_feats, self.text_adapter),
                                  (1, ref_audio_feats, self.audio_adapter),
                                  (2, input_audio_feats, self.audio_adapter)):
            if feats is not None:
                parts += [sep(i), adapter(feats.to(w.device, w.dtype))]
        parts.append(sep(3))
        return torch.cat(parts, dim=1)

    def loss(self, task_id, caption_feats, ref_audio_feats, input_audio_feats,
             codes):
        """Teacher-forced training loss over the delayed code sequence ->
        (loss, acc), fp32 scalars. codes (B, T, K) are the raw codes
        (acoustic, then semantic layers); delayed (``apply_delay``, holes
        PAD), they are read after BOS and predicted up to EOS (the last
        position of each dropped) behind the prompt. Per codebook the NLL
        and the argmax accuracy are averaged over the targets that are not
        PAD; both are then averaged over the K codebooks."""
        cfg = self.cfg
        codes = codes.to(self.audio_adapter.weight.device).long()
        b, _, k = codes.shape
        delayed = apply_delay(codes, cfg.pad)  # (B, T + K - 1, K)
        bos = torch.full_like(delayed[:, :1], cfg.bos)
        eos = torch.full_like(delayed[:, :1], cfg.eos)
        inputs = torch.cat([bos, delayed], dim=1)[:, :-1]
        targets = torch.cat([delayed, eos], dim=1)[:, :-1]
        prompt = self.build_prompt(task_id, caption_feats, ref_audio_feats,
                                   input_audio_feats, b)
        hidden = self.backbone.backbone(torch.cat(
            [prompt, self.embed_codes(inputs)], dim=1))[:, -targets.shape[1]:]
        loss = acc = 0.0
        for kk in range(cfg.num_codebooks):
            logits = self.heads[kk](hidden)
            logp = torch.log_softmax(logits.float(), dim=-1)
            tgt = targets[..., kk]
            nll = -logp.gather(-1, tgt[..., None])[..., 0]
            mask = (tgt != cfg.pad).float()
            n = torch.clamp(mask.sum(), min=1.0)
            loss = loss + (nll * mask).sum() / n
            acc = acc + ((logits.argmax(-1) == tgt).float() * mask).sum() / n
        return loss / cfg.num_codebooks, acc / cfg.num_codebooks

    @torch.no_grad()
    def generate(self, task_id, caption_feats, ref_audio_feats,
                 input_audio_feats, num_frames: int,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.8, top_k: int = 50,
                 top_p: float = 0.95, do_sample: bool = True,
                 batch: int = 1):
        """AR decode of ``num_frames`` frames -> codes (B, T, K) int32: one
        step per delayed position (num_frames + K - 1 steps), codebook k
        restricted to real codes for steps [k, k + num_frames) and to PAD
        outside; the delay is undone at the end."""
        cfg = self.cfg
        k = cfg.num_codebooks
        steps = num_frames + k - 1
        prompt = self.build_prompt(task_id, caption_feats, ref_audio_feats,
                                   input_audio_feats, batch)
        b, prompt_len, _ = prompt.shape
        dev = prompt.device
        cache = init_cache(self.lcfg, b, prompt_len + steps + 1,
                           dtype=prompt.dtype, device=dev)
        self.backbone.cached_forward(prompt, cache)
        code_mask, pad_only = delay_window_masks(cfg, dev)
        ids = torch.full((b, k), cfg.bos, dtype=torch.long, device=dev)
        out = []
        for step in range(steps):
            hidden, _ = self.backbone.cached_forward(
                self.embed_codes(ids)[:, None], cache)
            toks = []
            for kk in range(k):
                logits = self.heads[kk](hidden[:, -1])
                mask = code_mask if kk <= step < kk + num_frames else pad_only
                toks.append(sample_logits(generator, logits + mask,
                                          temperature, top_k, top_p,
                                          do_sample))
            ids = torch.stack(toks, dim=-1).long()
            out.append(ids)
        codes = undo_delay(torch.stack(out, dim=1))
        return codes.clamp(0, cfg.codebook_size - 1).int()
