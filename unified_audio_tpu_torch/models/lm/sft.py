"""UniSE task-conditioned LM (LLM_SFT): prompt assembly, the SFT loss and
two-phase generation.

Port of ``unified_audio_tpu/models/lm/sft.py``. Prompt layout:
[task][enroll_sos][enroll feats][mix_sos][mix feats][codec ids].

The SFT loss (``forward``) teacher-forces the codec ids
[gSOS g sSOS s] against the targets [g sSOS s sEOS]: unlike pretraining,
the semantic EOS target is kept.

The stack under the conditioning is chosen by the config
(:func:`build_sft`): ``llama.py``'s for a ``LlamaConfig``, Moonlight's
(``moonlight.py``, latent attention and routed experts) for a
``MoonlightConfig`` (:class:`MoonlightSFT`).

Generation runs two phases over a dense KV cache:

* phase 1: ``global_length + 1`` steps restricted to the global-token range;
  the last sample is discarded but its key/value stays cached (the
  reference's quirk, kept so tokens match);
* phase 2: ``semantic_length`` steps restricted to the semantic range.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .llama import CodecLM, LlamaConfig, range_mask, sample_logits
from .moonlight import MoonlightBackbone, MoonlightConfig


class LLMSFT(CodecLM):
    """CodecLM plus the SFT conditioning: task embedding, enroll/mix SOS
    embeddings and the feature adapter. State-dict keys follow the
    reference layout (``task_embedding.weight``, ``adapter.weight``, ...)."""

    def __init__(self, cfg: LlamaConfig, num_tasks: int = 3,
                 feats_dim: int = 768):
        super().__init__(cfg)
        d = cfg.hidden_size
        self.num_tasks = num_tasks
        self.feats_dim = feats_dim
        self.task_embedding = nn.Embedding(num_tasks, d)
        self.enroll_sos_embedding = nn.Embedding(1, d)
        self.mix_sos_embedding = nn.Embedding(1, d)
        self.adapter = nn.Linear(feats_dim, d)

    def prompt(self, task_id, enroll_feats, mix_feats):
        """task_id: int (one task for the batch) or (B,) tensor; feats
        (B, T, feats_dim) -> prompt embeddings (B, T_prompt, D)."""
        b = mix_feats.shape[0]
        dev = mix_feats.device
        dtype = self.adapter.weight.dtype
        task_ids = torch.as_tensor(task_id, device=dev).long()
        if task_ids.dim() == 0:
            task_ids = task_ids.expand(b)
        d = self.cfg.hidden_size
        parts = [self.task_embedding(task_ids.view(b, 1))]
        if enroll_feats is not None:
            parts += [self.enroll_sos_embedding.weight[None].expand(b, 1, d),
                      self.adapter(enroll_feats.to(dtype))]
        parts += [self.mix_sos_embedding.weight[None].expand(b, 1, d),
                  self.adapter(mix_feats.to(dtype))]
        return torch.cat(parts, dim=1)

    def forward(self, task_id, enroll_feats, mix_feats, global_ids,
                semantic_ids, stack=None):
        """SFT loss: global_ids (B, G), semantic_ids (B, T) -> (loss, acc)
        over the G + T + 2 targets. ``stack(embeds)`` runs the layer stack
        instead of the dense loop (``parallel/pipeline.py
        sft_pipeline_loss``)."""
        cfg = self.cfg
        b, dev = global_ids.shape[0], global_ids.device

        def special(i):
            return torch.full((b, 1), i, dtype=torch.long, device=dev)

        g = global_ids.long() + cfg.global_offset
        s = semantic_ids.long() + cfg.semantic_offset
        input_ids = torch.cat([special(cfg.global_sos), g,
                               special(cfg.semantic_sos), s], dim=1)
        target_ids = torch.cat([g, special(cfg.semantic_sos), s,
                                special(cfg.semantic_eos)], dim=1)
        embeds = torch.cat([self.prompt(task_id, enroll_feats, mix_feats),
                            self.embed_codes(input_ids)], dim=1)
        return self.forward_embeds(embeds, target_ids, stack)

    @torch.no_grad()
    def generate(self, task_id, enroll_feats, mix_feats,
                 generator: Optional[torch.Generator] = None,
                 global_length: int = 32,
                 semantic_length: Optional[int] = None,
                 temperature: float = 0.8, top_k: int = 50,
                 top_p: float = 0.95, do_sample: bool = True):
        """Two-phase AR decode -> (global_ids (B, global_length),
        semantic_ids (B, semantic_length)), int32."""
        cfg = self.cfg
        if semantic_length is None:
            semantic_length = mix_feats.shape[1]
        prompt = self.prompt(task_id, enroll_feats, mix_feats)
        b, prompt_len, _ = prompt.shape
        dev = prompt.device
        max_len = prompt_len + (global_length + 1) + semantic_length + 1
        cache = self.init_cache(b, max_len, dtype=prompt.dtype, device=dev)
        _, cache = self.prefill(prompt, cache)

        def phase(mask, first_id, steps):
            ids = torch.full((b,), first_id, dtype=torch.long, device=dev)
            out = []
            for _ in range(steps):
                logits, _ = self.decode_ids(ids, cache)
                ids = sample_logits(generator, logits + mask, temperature,
                                    top_k, top_p, do_sample).long()
                out.append(ids)
            return torch.stack(out, dim=1).int()

        g = phase(range_mask(cfg, cfg.global_offset, cfg.global_size, dev),
                  cfg.global_sos, global_length + 1)
        s = phase(range_mask(cfg, cfg.semantic_offset, cfg.semantic_size,
                             dev), cfg.semantic_sos, semantic_length)
        return g[:, :global_length] - cfg.global_offset, \
            s - cfg.semantic_offset


class MoonlightSFT(LLMSFT, MoonlightBackbone):
    """:class:`LLMSFT` over the Moonlight stack: the conditioning, the codec
    embedding and head of ``LLMSFT``, the layers and the latent cache of
    ``MoonlightBackbone`` (which stands before ``LlamaBackbone`` in the
    method order)."""


def build_sft(cfg, num_tasks: int = 3, feats_dim: int = 768) -> LLMSFT:
    """The task-conditioned LM over the stack ``cfg`` names: a
    ``LlamaConfig`` gives :class:`LLMSFT`, a ``MoonlightConfig``
    :class:`MoonlightSFT`."""
    cls = MoonlightSFT if isinstance(cfg, MoonlightConfig) else LLMSFT
    return cls(cfg, num_tasks=num_tasks, feats_dim=feats_dim)
