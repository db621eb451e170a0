"""Llama-style AR-LM over the codec vocabulary, with a dense KV cache and
top-k/top-p sampling.

Port of ``unified_audio_tpu/models/lm/llama.py``: ``LlamaConfig`` (its
codec vocabulary's layout in ``CodecVocab``, which ``moonlight.py``'s
config shares), ``init_cache``, ``range_mask``, ``LlamaBackbone`` (the
decoder stack: the uncached causal forward that training runs, prefill
and one-token decode over embeddings and a dense cache, and
``decode_step_multi``, the one-token decode in which each sequence sits
at its own depth),
``CodecLM`` (with the label-smoothed loss, ``forward_embeds``, the
pretraining objective ``pretrain_loss``, JAX's ``CodecLM.__call__``, and
``decode_ids_multi``), ``sample_logits`` (the reference's first-crossing
top-p rule) and the per-row ``sample_logits_vec``.

Parameters use the reference torch layout (``codec_embedding.weight``,
``layers.{i}.self_attn.q_proj.weight``, ..., ``norm.weight``,
``output_head.weight``), the layout ``export_custom_llama_state_dict``
writes, so a reference state dict loads with ``load_state_dict``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ...nn.transformer import RMSNorm, apply_rope, rope_cos_sin
from ...parallel.mesh import (copy_to_group, gather_from_group,
                              reduce_from_group)

NEG_INF = -1e9


class CodecVocab:
    """The codec vocabulary's layout, shared by the backbones' configs:
    [global_sos, semantic_sos, semantic_eos, global ids, semantic ids]."""

    @property
    def global_sos(self) -> int:
        return 0

    @property
    def semantic_sos(self) -> int:
        return 1

    @property
    def semantic_eos(self) -> int:
        return 2

    @property
    def global_offset(self) -> int:
        return 3

    @property
    def semantic_offset(self) -> int:
        return 3 + self.global_size


@dataclass(frozen=True)
class LlamaConfig(CodecVocab):
    global_size: int = 4096
    semantic_size: int = 8192
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    max_position_embeddings: int = 4096
    label_smoothing: float = 0.1
    rope_theta: float = 10000.0
    dropout_p: float = 0.0

    @property
    def vocab_size(self) -> int:
        return 3 + self.global_size + self.semantic_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rope_dim(self) -> int:
        """The width RoPE rotates: each head's whole query and key."""
        return self.head_dim

    @property
    def cache_rows(self) -> dict:
        """The cache's row width per entry and position: every head's K
        and V."""
        width = self.num_heads * self.head_dim
        return {"k": width, "v": width}


def cache_len(cache) -> int:
    """Positions a dense cache holds (any backbone's)."""
    return next(v for k, v in cache.items() if k != "index").shape[2]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    """Dense KV cache {k, v: (L, B, max_len, H, hd), index: next position}."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def range_mask(cfg: LlamaConfig, offset: int, size: int,
               device=None) -> torch.Tensor:
    """Additive (V,) fp32 mask: 0 inside [offset, offset+size), NEG_INF
    outside (the per-phase vocabulary restriction)."""
    idx = torch.arange(cfg.vocab_size, device=device)
    inside = (idx >= offset) & (idx < offset + size)
    return torch.where(inside, 0.0, NEG_INF)


class LlamaAttention(nn.Module):
    """Self-attention over ``q_proj.weight.shape[0] // head_dim`` heads: all
    of them, or this rank's H/tp once ``parallel/mesh.py shard_lm_`` has
    cut the projections and set ``tp_group``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.o_proj = nn.Linear(d, d, bias=False)
        self.tp_group = None

    @property
    def local_heads(self) -> int:
        return self.q_proj.weight.shape[0] // self.cfg.head_dim

    def project_in(self, x):
        """x (..., D) -> this rank's q, k, v, each (..., H_local * hd)."""
        x = copy_to_group(x, self.tp_group)
        return self.q_proj(x), self.k_proj(x), self.v_proj(x)

    def project_out(self, attn):
        """(..., H_local * hd) -> (..., D), summed over tp."""
        return reduce_from_group(self.o_proj(attn), self.tp_group)

    def forward(self, x, mask, cos, sin, cache, li: int):
        """x (B, S, D). With a cache, the new K/V rows are written into it
        at its index IN PLACE (the cache is one preallocated buffer, so no
        copy of it is made per step) and the attention reads the whole
        buffer; without one (training), it reads the S new rows."""
        b, s, _ = x.shape
        h, hd = self.local_heads, self.cfg.head_dim
        q, k, v = self.project_in(x)
        q, k, v = (t.view(b, s, h, hd) for t in (q, k, v))
        q, k = apply_rope(q, k, cos, sin)
        if cache is not None:
            idx = cache["index"]
            if isinstance(idx, torch.Tensor) and idx.dim() == 1:
                # per-sequence positions (s == 1): row b writes at idx[b]
                rows = torch.arange(b, device=idx.device)
                cache["k"][li, rows, idx] = k[:, 0].to(cache["k"].dtype)
                cache["v"][li, rows, idx] = v[:, 0].to(cache["v"].dtype)
            else:
                cache["k"][li, :, idx:idx + s] = k.to(cache["k"].dtype)
                cache["v"][li, :, idx:idx + s] = v.to(cache["v"].dtype)
            k, v = cache["k"][li], cache["v"][li]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
        probs = torch.softmax(logits + mask, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
        return self.project_out(out)


class LlamaMLP(nn.Module):
    """The gated MLP; under tp each rank holds 4D/tp of its channels."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        d, inter = cfg.hidden_size, cfg.hidden_size * 4
        self.gate_proj = nn.Linear(d, inter, bias=False)
        self.up_proj = nn.Linear(d, inter, bias=False)
        self.down_proj = nn.Linear(inter, d, bias=False)
        self.tp_group = None

    def forward(self, x):
        x = copy_to_group(x, self.tp_group)
        return reduce_from_group(self.down_proj(
            nn.functional.silu(self.gate_proj(x)) * self.up_proj(x)),
            self.tp_group)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(cfg)
        self.mlp = LlamaMLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size)

    def forward(self, x, mask, cos, sin, cache, li: int):
        x = x + self.self_attn(self.input_layernorm(x), mask, cos, sin,
                               cache, li)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaBackbone(nn.Module):
    """The decoder stack (``layers``, ``norm``) over input embeddings:
    :meth:`backbone` is the full causal forward (training);
    :meth:`cached_forward` is both the prefill of a prompt and a one-token
    decode step over a dense cache."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            [LlamaLayer(cfg) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
        """This stack's dense cache (:func:`init_cache`)."""
        return init_cache(self.cfg, batch, max_len, dtype, device)

    def backbone(self, embeds, stack=None):
        """(B, S, D) -> normed hidden states (B, S, D), every position
        attending to itself and the ones before it. ``stack(embeds)``, if
        given, runs the layers instead of the loop here (the pipeline,
        ``parallel/pipeline.py``)."""
        if stack is not None:
            return self.norm(stack(embeds))
        cfg = self.cfg
        s = embeds.shape[1]
        pos = torch.arange(s, device=embeds.device)
        cos, sin = rope_cos_sin(pos, cfg.rope_dim, cfg.rope_theta)
        mask = torch.where(pos[None] <= pos[:, None], 0.0, NEG_INF)
        x = embeds
        for li, layer in enumerate(self.layers):
            x = layer(x, mask, cos, sin, None, li)
        return self.norm(x)

    def cached_forward(self, embeds, cache):
        """Write S new positions at cache["index"]; returns the normed
        hidden states (B, S, D) and the cache with its index advanced."""
        cfg = self.cfg
        s = embeds.shape[1]
        max_len = cache_len(cache)
        idx = cache["index"]
        dev = embeds.device
        positions = idx + torch.arange(s, device=dev)
        cos, sin = rope_cos_sin(positions, cfg.rope_dim, cfg.rope_theta)
        # key j is visible to query i iff j <= idx + i
        key_pos = torch.arange(max_len, device=dev)[None]
        mask = torch.where(key_pos <= positions[:, None], 0.0, NEG_INF)
        x = embeds
        for li, layer in enumerate(self.layers):
            x = layer(x, mask, cos, sin, cache, li)
        cache["index"] = idx + s
        return self.norm(x), cache

    def decode_step_multi(self, embeds, cache):
        """One-token decode in which each sequence sits at its own depth:
        embeds (B, 1, D), ``cache["index"]`` a (B,) int tensor on the
        cache's device. Row b's K/V are written at position index[b], its
        query is rotated there and sees keys 0..index[b]; the index
        advances by one. Nothing is read back to the host.

        An index equal to ``max_len`` is out of range: the write raises
        an IndexError on the CPU and a device-side assert on the card (the
        JAX package's scatter drops such a write; ROADMAP hazard 30). The
        caller keeps every index below ``max_len``."""
        cfg = self.cfg
        max_len = cache_len(cache)
        idx = cache["index"]
        cos, sin = rope_cos_sin(idx[:, None], cfg.rope_dim, cfg.rope_theta)
        key_pos = torch.arange(max_len, device=idx.device)
        mask = torch.where(key_pos[None] <= idx[:, None], 0.0, NEG_INF)
        mask = mask[:, None, None]  # (B, 1, 1, max_len) over (B, H, 1, K)
        x = embeds
        for li, layer in enumerate(self.layers):
            x = layer(x, mask, cos, sin, cache, li)
        cache["index"] = idx + 1
        return self.norm(x), cache


class CodecLM(LlamaBackbone):
    """Codec embedding + decoder stack + output head over the
    3 + global + semantic vocabulary (the stack's keys stay at the top
    level: ``layers.*``, ``norm.weight``)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__(cfg)
        self.codec_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.output_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False)
        self.tp_group = None

    def _gathered(self, x, weight):
        """``x`` made whole over tp where ``weight`` is cut
        (``parallel/mesh.py``: the embedding over D, the head over V)."""
        if getattr(weight, "tp_dim", None) is None:
            return x
        return gather_from_group(x, self.tp_group)

    def embed_codes(self, ids):
        """ids (...) -> (..., D) code embeddings."""
        return self._gathered(self.codec_embedding(ids),
                              self.codec_embedding.weight)

    def head(self, hidden):
        """(..., D) -> (..., V) logits."""
        return self._gathered(self.output_head(hidden),
                              self.output_head.weight)

    def loss_function(self, logits, targets):
        """Label-smoothed KL divergence, averaged over tokens: the target
        distribution is ``smoothing / (V - 1)`` everywhere and ``1 -
        smoothing`` at the target. Computed in closed form, without the
        (N, V) target distribution:
        sum_j t_j (log t_j - logp_j) = C - fill sum_j logp_j
        - (conf - fill) logp_target, C = (V - 1) fill log fill
        + conf log conf."""
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.reshape(-1, v).float(), dim=-1)
        targets = targets.reshape(-1).long()
        conf = 1.0 - self.cfg.label_smoothing
        fill = self.cfg.label_smoothing / (v - 1)
        const = (v - 1) * fill * math.log(fill) + conf * math.log(conf)
        kl = (const - fill * logp.sum(dim=-1)
              - (conf - fill) * logp.gather(-1, targets[:, None])[:, 0])
        return kl.sum() / logp.shape[0]

    def forward_embeds(self, embeds, target_ids, stack=None):
        """Training forward over an assembled embedding sequence: the loss
        and the accuracy of the trailing ``target_ids.shape[1]`` positions
        -> (loss, acc), fp32 scalars. ``stack``: see :meth:`backbone`."""
        t = target_ids.shape[-1]
        logits = self.head(self.backbone(embeds, stack)[:, -t:])
        loss = self.loss_function(logits, target_ids)
        acc = (torch.argmax(logits, dim=-1) == target_ids).float().mean()
        return loss, acc

    def pretrain_loss(self, global_ids, semantic_ids, cond_embeds=None):
        """The pretraining objective over (global (B, Ng), semantic (B, T))
        token ids -> (loss, acc): the sequence [gSOS g... sSOS s...] (the
        ids shifted to their vocabulary ranges) predicts itself shifted
        by one, [g... sSOS s... sEOS], each without its last position, so
        the final EOS target is dropped (pretraining clips may be cut
        mid-utterance). ``cond_embeds`` (B, Tc, D) go first if given."""
        cfg = self.cfg
        b, dev = global_ids.shape[0], self.codec_embedding.weight.device
        g = global_ids.to(dev).long() + cfg.global_offset
        s = semantic_ids.to(dev).long() + cfg.semantic_offset

        def tok(i):
            return torch.full((b, 1), i, dtype=torch.long, device=dev)

        input_ids = torch.cat([tok(cfg.global_sos), g, tok(cfg.semantic_sos),
                               s], dim=1)[:, :-1]
        target_ids = torch.cat([g, tok(cfg.semantic_sos), s,
                                tok(cfg.semantic_eos)], dim=1)[:, :-1]
        embeds = self.embed_codes(input_ids)
        if cond_embeds is not None:
            embeds = torch.cat([cond_embeds.to(embeds.dtype), embeds], dim=1)
        return self.forward_embeds(embeds, target_ids)

    def prefill(self, embeds, cache):
        hidden, cache = self.cached_forward(embeds, cache)
        return self.head(hidden[:, -1]), cache

    def decode_ids(self, ids, cache):
        """ids (B,) -> (logits (B, V), cache): one decode step."""
        hidden, cache = self.cached_forward(self.embed_codes(ids[:, None]),
                                            cache)
        return self.head(hidden[:, -1]), cache

    def decode_ids_multi(self, ids, cache):
        """ids (B,) with per-sequence positions (``cache["index"]`` (B,))
        -> (logits (B, V), cache): :meth:`decode_step_multi` of their
        embeddings."""
        hidden, cache = self.decode_step_multi(
            self.embed_codes(ids[:, None]), cache)
        return self.head(hidden[:, -1]), cache


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def filter_logits(logits, top_k: int = 50, top_p: float = 0.95):
    """Top-k then top-p filter of (B, V) logits; filtered entries become
    NEG_INF. Keeps the first token whose cumulative probability crosses
    ``top_p``."""
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        vals = torch.topk(logits, k, dim=-1).values  # sorted descending
        logits = torch.where(logits < vals[..., -1:], NEG_INF, logits)
        if top_p < 1.0:
            cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
            remove_sorted = torch.cat(
                [torch.zeros_like(cum[..., :1], dtype=torch.bool),
                 (cum > top_p)[..., :-1]], dim=-1)
            kept_min = torch.where(remove_sorted, torch.inf, vals).amin(
                dim=-1, keepdim=True)
            logits = torch.where(logits < kept_min, NEG_INF, logits)
    elif top_p < 1.0:
        # descending order with ties in reverse index order, as a reversed
        # stable ascending sort gives
        order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
        sorted_logits = torch.gather(logits, -1, order)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = torch.cat(
            [torch.zeros_like(cum[..., :1], dtype=torch.bool),
             (cum > top_p)[..., :-1]], dim=-1)
        remove = torch.empty_like(remove_sorted).scatter_(-1, order,
                                                          remove_sorted)
        logits = torch.where(remove, NEG_INF, logits)
    return logits


def _categorical(logits, generator: Optional[torch.Generator]):
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].int()


def sample_logits(generator, logits, temperature: float = 0.8,
                  top_k: int = 50, top_p: float = 0.95,
                  do_sample: bool = True) -> torch.Tensor:
    """(B, V) range-masked logits -> (B,) int32 tokens: argmax, or top-k,
    top-p, temperature and a draw from ``generator``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1).int()
    return _categorical(filter_logits(logits, top_k, top_p) / temperature,
                        generator)


def filter_logits_vec(logits, top_k, top_p, max_top_k: int = 256):
    """Per-row top-k (B,) and top-p (B,) filter: one topk with a static
    ``max_top_k`` covers every row's k through a per-row threshold; the
    top-p cumsum runs over each row's own top-k entries."""
    b, v = logits.shape
    kmax = min(max_top_k, v)
    vals = torch.topk(logits, kmax, dim=-1).values
    col = torch.arange(kmax, device=logits.device)[None]
    k = top_k.long().clamp(1, kmax)
    kth = torch.gather(vals, -1, (k - 1)[:, None])
    filt = torch.where(logits < kth, NEG_INF, logits)
    vals_k = torch.where(col < k[:, None], vals, NEG_INF)
    cum = torch.cumsum(torch.softmax(vals_k, dim=-1), dim=-1)
    remove_sorted = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=logits.device),
         (cum > top_p[:, None])[:, :-1]], dim=-1)
    kept_min = torch.where(remove_sorted, torch.inf, vals_k).amin(
        dim=-1, keepdim=True)
    return torch.where(filt < kept_min, NEG_INF, filt)


def sample_logits_vec(generator, logits, temperature, top_k, top_p,
                      do_sample, max_top_k: int = 256) -> torch.Tensor:
    """Per-row sampling parameters (each (B,)): same semantics as
    :func:`sample_logits`; rows with ``do_sample`` False take the argmax.
    Returns (B,) int32."""
    greedy = torch.argmax(logits, dim=-1).int()
    filt = filter_logits_vec(logits, top_k, top_p, max_top_k)
    sampled = _categorical(filt / temperature[:, None], generator)
    return torch.where(do_sample, sampled, greedy)
