"""Moonlight-16B-A3B's decoder stack (DeepSeek-V3's layers) as a backbone
of the codec LM.

No counterpart in the JAX package: the port's own backbone beside
``llama.py``'s, with its interface (``backbone``, ``cached_forward``,
``decode_step_multi``, ``init_cache``), so that ``LLMSFT``, ``UniSE`` and
the serving engine take it through their normal entry points
(``sft.py build_sft`` picks the stack from the config). The layers, after
https://huggingface.co/moonshotai/Moonlight-16B-A3B (``model_type``
deepseek_v3):

* multi-head latent attention (MLA) in every layer: q = W_q h, per head
  q_nope (``qk_nope_head_dim``) and q_pe (``qk_rope_head_dim``);
  [c_kv, k_pe] = W_kva h, c_kv RMS-normed; [k_nope, v] = W_kvb c_kv per
  head; RoPE on q_pe and on the one k_pe all heads share; softmax at
  (nope + rope)^-0.5; ``o_proj``. Without a cache (training) it runs in
  this naive form. With one, the cache holds per position only the latent
  row [normed c_kv, roped k_pe] (``kv_lora_rank + qk_rope_head_dim``
  wide), and attention runs in the absorbed form: each head's q_nope is
  taken through its W_uk into the latent space, the heads attend over the
  shared rows, and each head's latent output is taken through its W_uv;
* a dense gated MLP (``intermediate_size``) in the first
  ``first_k_dense_replace`` layers, then ``nn/transformer.py MoE``: the
  sigmoid router (fp32) choosing ``num_experts_per_tok`` of
  ``n_routed_experts`` on the scores plus a correction bias (``noaux_tc``
  with one group), renormalized (``norm_topk_prob``) and scaled by
  ``routed_scaling_factor``, routed dispatch, and the
  ``n_shared_experts`` shared experts as one gated MLP.

Precision: the stack computes in its weights' dtype (bf16 as ``cli
serve`` casts it), the residual stream, the activations and the latent
cache included, as DeepSeek-V3's published code does; RMSNorm, the
softmax and the router run in fp32.

Departures from DeepSeek-V3's published code: RoPE pairs dimension i with
i + rope/2 (``rotate_half``, as the rest of the port) where DeepSeek pairs
neighbours; a checkpoint converts by permuting the rope rows of ``q_proj``
and ``kv_a_proj_with_mqa``. The routing weights are renormalized without
DeepSeek's 1e-20 added to their sum. Parameters follow DeepSeek's names
for the attention (``self_attn.q_proj``, ``kv_a_proj_with_mqa``,
``kv_a_layernorm``, ``kv_b_proj``, ``o_proj``) and the port's for the
MLPs (``mlp.w1/w2/w3``; ``mlp.gate_linear``, ``mlp.gate_bias``, the
stacked ``mlp.expert_w*``, ``mlp.shared_expert.*``), the codec head's as
``llama.py``'s (``codec_embedding``, ``norm``, ``output_head``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...nn.transformer import GatedMLP, MoE, RMSNorm, attend, rope_rotate
from ...ops.cuda.latent_attention import latent_attention
from ...utils.profiling import span
from .llama import CodecVocab, LlamaBackbone


@dataclass(frozen=True)
class MoonlightConfig(CodecVocab):
    """Moonlight-16B-A3B's published sizes; the codec vocabulary (3 +
    global + semantic ids) at the front of ``vocab_size`` rows."""
    global_size: int = 4096
    semantic_size: int = 8192
    vocab_size: int = 20480
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192
    label_smoothing: float = 0.1

    def __post_init__(self):
        if self.vocab_size < 3 + self.global_size + self.semantic_size:
            raise ValueError(
                f"vocab_size {self.vocab_size} cannot hold the 3 + "
                f"{self.global_size} + {self.semantic_size} codec ids")

    @property
    def rope_dim(self) -> int:
        return self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a cached position: the normed c_kv and the roped k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def cache_rows(self) -> dict:
        """The cache's row width per entry and position: one latent row,
        shared by every head."""
        return {"kv": self.latent_dim}


class LatentAttention(nn.Module):
    """Multi-head latent attention (module docstring): naive without a
    cache, absorbed over the cache's latent rows with one."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        self.cfg = cfg
        self.q_proj = nn.Linear(
            d, h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(
            cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, d, bias=False)
        self.scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5

    @property
    def local_heads(self) -> int:
        """Every head: the latent rows are shared by all of them, so the
        stack has no tensor-parallel cut."""
        return self.cfg.num_heads

    def queries(self, x, cos, sin):
        """x (B, S, D) -> q_nope (B, S, H, nope), roped q_pe (B, S, H,
        rope)."""
        cfg = self.cfg
        q = self.q_proj(x).view(*x.shape[:2], cfg.num_heads, -1)
        q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                               dim=-1)
        return q_nope, rope_rotate(q_pe, cos, sin)

    def latent(self, x, cos, sin):
        """x (B, S, D) -> the latent rows (B, S, rank + rope): the normed
        c_kv and the roped k_pe."""
        c, k_pe = self.kv_a_proj_with_mqa(x).split(
            [self.cfg.kv_lora_rank, self.cfg.qk_rope_head_dim], dim=-1)
        k_pe = rope_rotate(k_pe[:, :, None], cos, sin)[:, :, 0]
        return torch.cat([self.kv_a_layernorm(c), k_pe], dim=-1)

    def naive(self, x, mask, cos, sin):
        """Attention over x's own positions, keys and values expanded per
        head from the latent rows -> (B, S, H * v)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q_nope, q_pe = self.queries(x, cos, sin)
        rows = self.latent(x, cos, sin)
        c, k_pe = rows.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
        kv = self.kv_b_proj(c).view(b, s, cfg.num_heads, -1)
        k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], -1)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(
            b, s, cfg.num_heads, cfg.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        return attend(q, k, v, mask, self.scale).reshape(b, s, -1)

    def absorbed(self, q_nope, q_pe, rows, pos0, tables=None):
        """q_nope (B, S, H, nope), q_pe (B, S, H, rope) over the latent
        rows where they lie (``ops/cuda/latent_attention.py``: a dense
        cache's layer (B, T, rank + rope), or a pool's layer (NB, BS, rank +
        rope) through ``tables``), query s of row b at position ``pos0[b] +
        s`` seeing the keys up to it -> (B, S, H * v). Each head's q_nope is
        taken through its W_uk before and its latent output through its
        W_uv after the attention (K8 on the card, its plain version on the
        CPU)."""
        cfg = self.cfg
        r = cfg.kv_lora_rank
        w = self.kv_b_proj.weight.view(cfg.num_heads, -1, r)
        w_uk, w_uv = w.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=1)
        q = torch.cat([torch.einsum("bshn,hnr->bshr", q_nope, w_uk), q_pe],
                      dim=-1)
        out = latent_attention(q, rows, pos0, r, self.scale, tables)
        out = torch.einsum("bshr,hvr->bshv", out, w_uv)
        return out.reshape(*out.shape[:2], -1)

    def forward(self, x, mask, cos, sin, cache, li: int):
        """x (B, S, D). With a cache,
        the new latent rows are written into ``cache["kv"][li]`` at its
        index, in place (per row where the index is a (B,) tensor), and the
        S queries attend causally over the buffer (``mask`` is the naive
        form's alone: a cache's is the causal one of its index); without
        one, the naive form over the S new positions."""
        with span("lm.mla"):
            if cache is None:
                return self.o_proj(self.naive(x, mask, cos, sin))
            b, s, _ = x.shape
            q_nope, q_pe = self.queries(x, cos, sin)
            rows = self.latent(x, cos, sin).to(cache["kv"].dtype)
            idx = cache["index"]
            if isinstance(idx, torch.Tensor) and idx.dim() == 1:
                cache["kv"][li, torch.arange(b, device=idx.device), idx] = \
                    rows[:, 0]
                pos0 = idx.int()
            else:
                cache["kv"][li, :, idx:idx + s] = rows
                pos0 = torch.full((b,), int(idx), dtype=torch.int32,
                                  device=x.device)
            return self.o_proj(self.absorbed(q_nope, q_pe, cache["kv"][li],
                                             pos0))

    def paged(self, x, cos, sin, layer_rows, blk, off, tables, index):
        """The decode step over a latent pool's layer ``layer_rows`` (NB,
        BS, rank + rope): x (S, 1, D); each slot's new row written at
        (``blk``, ``off``), then attended with the rows its table (S, MB)
        names up to its ``index`` (S,) int32 (-1: an inactive slot, whose
        output is zeros) -> (S, 1, D)."""
        with span("lm.mla"):
            q_nope, q_pe = self.queries(x, cos, sin)
            layer_rows[blk, off] = self.latent(x, cos, sin)[:, 0].to(
                layer_rows.dtype)
            return self.o_proj(self.absorbed(q_nope, q_pe, layer_rows, index,
                                             tables))


class MoonlightLayer(nn.Module):
    """Pre-norm latent attention, then the dense MLP (the first
    ``first_k_dense_replace`` layers) or the routed experts."""

    def __init__(self, cfg: MoonlightConfig, li: int):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = LatentAttention(cfg)
        if li < cfg.first_k_dense_replace:
            self.mlp = GatedMLP(d, cfg.intermediate_size)
        else:
            self.mlp = MoE(d, cfg.moe_intermediate_size,
                           cfg.n_routed_experts, cfg.num_experts_per_tok,
                           cfg.n_shared_experts, cfg.routed_scaling_factor,
                           "sigmoid")
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps)

    def forward(self, x, mask, cos, sin, cache, li: int):
        x = x + self.self_attn(self.input_layernorm(x), mask, cos, sin,
                               cache, li)
        return x + self.mlp(self.post_attention_layernorm(x))


class MoonlightBackbone(LlamaBackbone):
    """The Moonlight stack (``layers``, ``norm``) behind ``LlamaBackbone``'s
    methods, which read the RoPE width from the config and the cache's
    length from its one entry; only the layers and the cache differ."""

    def __init__(self, cfg: MoonlightConfig):
        # the Llama stack's __init__ would build Llama layers: only the
        # module's own set-up is shared
        nn.Module.__init__(self)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            [MoonlightLayer(cfg, li) for li in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None):
        """Dense latent cache {kv: (L, B, max_len, rank + rope), index}."""
        cfg = self.cfg
        return {"kv": torch.zeros((cfg.num_layers, batch, max_len,
                                   cfg.latent_dim), dtype=dtype,
                                  device=device),
                "index": 0}
