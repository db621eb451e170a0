"""Operations and bytes of a Moonlight (DeepSeek-V3 layer) LM, counted from
the configuration's sizes: the model operations of a token (2 per weight
it uses, the attention's products over its context) and the least bytes
a decode step must move (each weight it needs read once, each latent row
of the live contexts read once). ``c`` is the configuration's top-level
published keys with ``codec_vocab`` merged in (the reference's
``lm_sizes``).
"""
from __future__ import annotations


def attention_weights(c: dict) -> int:
    """One layer's MLA weights (q, kv_a with its norm, kv_b, o)."""
    d, h, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rope, v = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"])
    return (d * h * (nope + rope) + d * (r + rope) + r
            + r * h * (nope + v) + h * v * d)


def expert_weights(c: dict) -> int:
    """One routed expert's gated MLP."""
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def moe_layers(c: dict) -> int:
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


def dense_weights(c: dict) -> int:
    """What every token reads whatever its routing: the attention of every
    layer, the dense layers' MLPs, each MoE layer's router and shared
    experts, the norms."""
    d = c["hidden_size"]
    shared = c["n_shared_experts"] * expert_weights(c)
    gate = d * c["n_routed_experts"] + c["n_routed_experts"]
    return (c["num_hidden_layers"] * (attention_weights(c) + 2 * d)
            + c["first_k_dense_replace"] * 3 * d * c["intermediate_size"]
            + moe_layers(c) * (shared + gate) + d)


def token_flops(c: dict, context: int, head: bool = True) -> int:
    """Model operations of one token attending to ``context`` positions:
    2 per weight it uses (its ``num_experts_per_tok`` routed experts), 2
    per head and key of the query-key (nope + rope) and value products."""
    h = c["num_attention_heads"]
    att = 2 * h * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
                   + c["v_head_dim"]) * context
    used = (dense_weights(c) + moe_layers(c) * c["num_experts_per_tok"]
            * expert_weights(c))
    out = 2 * used + c["num_hidden_layers"] * att
    return out + (2 * c["hidden_size"] * c["vocab_size"] if head else 0)


def experts_reached(c: dict, tokens: int) -> float:
    """Expected routed experts of a layer that ``tokens`` tokens reach, each
    choosing k of E at random: E (1 - ((E - k) / E) ** tokens)."""
    e, k = c["n_routed_experts"], c["num_experts_per_tok"]
    return e * (1.0 - ((e - k) / e) ** tokens)


def step_bytes(c: dict, contexts, elem_bytes: int = 2) -> float:
    """Least bytes of one decode step over the slots at ``contexts`` (each
    slot's positions after the step's write): the weights read once (the
    routed experts its tokens reach, at the expectation), the head, each
    token's embedding row, each live latent row read once and each new one
    written."""
    tokens = len(contexts)
    d = c["hidden_size"]
    latent = c["kv_lora_rank"] + c["qk_rope_head_dim"]
    weights = (dense_weights(c) + moe_layers(c) * experts_reached(c, tokens)
               * expert_weights(c) + d * c["vocab_size"])
    rows = c["num_hidden_layers"] * latent * (sum(contexts) + tokens)
    return elem_bytes * (weights + rows + tokens * d)
