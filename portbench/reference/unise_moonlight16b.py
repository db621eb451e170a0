"""Plain reference of the ``unise_moonlight16b`` configuration's serving
path: UniSE on a Moonlight-16B-A3B backbone.

The WavLM-base-plus frontend and BiCodec's decoder are the frozen plain
copies that ``unise.py`` uses; the LM is written out here: UniSE's prompt
[task, enroll SOS, enroll features, mix SOS, mix features] and the
Moonlight stack (DeepSeek-V3's layers,
https://huggingface.co/moonshotai/Moonlight-16B-A3B) teacher-forced over
the served codes, in full, in fp32, with no cache, no kernel and no
batching across requests:

* multi-head latent attention in DeepSeek-V3's naive form: q = W_q h,
  split per head into q_nope and q_pe; [c_kv, k_pe] = W_kva h, c_kv
  RMS-normed; [k_nope, v] = W_kvb c_kv per head; RoPE on q_pe and on the
  one k_pe every head shares; causal softmax at (nope + rope)^-0.5;
  ``o_proj``;
* layer 0's dense gated MLP; in the others every routed expert evaluated
  on every token (dense), weighted by the router's choice: sigmoid scores,
  the top ``num_experts_per_tok`` of the scores plus the correction bias,
  their scores renormalized and times ``routed_scaling_factor``; plus the
  shared experts.

Departures from DeepSeek-V3's published code: RoPE pairs dimension i with
i + rope/2 (``unise.py``'s ``rope``, GPT-NeoX's rotate-half) where DeepSeek
pairs neighbours (the same map under a fixed permutation of the rope rows
of ``q_proj`` and ``kv_a_proj_with_mqa``); the renormalization adds no
1e-20 to the sum. Parameter names are the port's, so one state dict loads
into either.

The stack is 15 B parameters, 61.5 GB in fp32: it is never held whole.
The embeddings, the prompt's modules, the final norm and the head stay;
each layer is made when the forward reaches it (``make_layer(li)``, which
the caller fills with that layer's weights), runs every sequence, and is
dropped.

``precision="fp8"`` is the control, the served LM one step down: its
weights (bf16) and each linear layer's and each expert's input and output
(computed at fp32 accuracy over those weights), the embeddings and the
logits rounded to float8 e4m3 under a per-tensor scale, and the residual
stream (fp32) rounded to bf16.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .frozen.bicodec import BiCodec, BiCodecConfig
from .frozen.wav2vec2 import SSLConfig, Wav2Vec2Model, wavlm_features
# gaps and support_gaps: the check's readings, as the unise cell reads them
from .unise import (Linear, RMSNorm, _tuples, fp8, gaps, rope,  # noqa: F401
                    support_gaps)


def lm_sizes(cfg: dict) -> dict:
    """The stack's sizes from the configuration file: the published keys
    at its top level, the codec ids' layout in ``codec_vocab``."""
    return {**{k: v for k, v in cfg.items() if not isinstance(v, (dict,
                                                                  list))},
            **cfg["codec_vocab"]}


class Attention(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d, h = c["hidden_size"], c["num_attention_heads"]
        rank, rope_d = c["kv_lora_rank"], c["qk_rope_head_dim"]
        self.q_proj = Linear(d, h * (c["qk_nope_head_dim"] + rope_d),
                             bias=False)
        self.kv_a_proj_with_mqa = Linear(d, rank + rope_d, bias=False)
        self.kv_a_layernorm = RMSNorm(rank, c["rms_norm_eps"])
        self.kv_b_proj = Linear(rank, h * (c["qk_nope_head_dim"]
                                           + c["v_head_dim"]), bias=False)
        self.o_proj = Linear(h * c["v_head_dim"], d, bias=False)


class Dense(nn.Module):
    def __init__(self, d: int, inter: int):
        super().__init__()
        self.w1 = Linear(d, inter, bias=False)
        self.w2 = Linear(inter, d, bias=False)
        self.w3 = Linear(d, inter, bias=False)


class Experts(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d, e, i = (c["hidden_size"], c["n_routed_experts"],
                   c["moe_intermediate_size"])
        self.gate_linear = Linear(d, e, bias=False)
        self.gate_bias = nn.Parameter(torch.zeros(e))
        self.expert_w1 = nn.Parameter(torch.zeros(e, d, i))
        self.expert_w3 = nn.Parameter(torch.zeros(e, d, i))
        self.expert_w2 = nn.Parameter(torch.zeros(e, i, d))
        self.shared_expert = Dense(d, c["n_shared_experts"] * i)


class Layer(nn.Module):
    """One layer of the stack, its parameters named as the port's."""

    def __init__(self, c: dict, li: int):
        super().__init__()
        d = c["hidden_size"]
        self.self_attn = Attention(c)
        self.mlp = (Dense(d, c["intermediate_size"])
                    if li < c["first_k_dense_replace"] else Experts(c))
        self.input_layernorm = RMSNorm(d, c["rms_norm_eps"])
        self.post_attention_layernorm = RMSNorm(d, c["rms_norm_eps"])


class LM(nn.Module):
    """What the stack keeps between layers: the codec embedding, the
    prompt's modules, the final norm and the head (parameters named as the
    port's ``MoonlightSFT``)."""

    def __init__(self, c: dict, feats_dim: int, num_tasks: int = 3):
        super().__init__()
        d = c["hidden_size"]
        self.cfg = c
        self.codec_embedding = nn.Embedding(c["vocab_size"], d)
        self.norm = RMSNorm(d, c["rms_norm_eps"])
        self.output_head = Linear(d, c["vocab_size"], bias=False)
        self.task_embedding = nn.Embedding(num_tasks, d)
        self.enroll_sos_embedding = nn.Embedding(1, d)
        self.mix_sos_embedding = nn.Embedding(1, d)
        self.adapter = Linear(feats_dim, d)

    precision = "fp32"

    def set_precision(self, precision: str):
        self.precision = precision
        for m in self.modules():
            if isinstance(m, Linear):
                m.precision = precision

    def _round(self, x):
        return fp8(x) if self.precision == "fp8" else x

    def _stream(self, x):
        """The residual stream in the control: bf16 (module docstring)."""
        return x.bfloat16().float() if self.precision == "fp8" else x

    def prompt(self, task, enroll_feats, mix_feats):
        """One request: feats (T, F) -> (T_prompt, D)."""
        dev = mix_feats.device
        parts = [self.task_embedding(torch.tensor([task], device=dev))]
        if enroll_feats is not None:
            parts += [self.enroll_sos_embedding.weight,
                      self.adapter(enroll_feats)]
        parts += [self.mix_sos_embedding.weight, self.adapter(mix_feats)]
        return torch.cat(parts)

    def attention(self, a: Attention, x):
        """Causal MLA over one sequence x (T, D), the naive form."""
        c = self.cfg
        t = x.shape[0]
        h, nope = c["num_attention_heads"], c["qk_nope_head_dim"]
        rank, rope_d, v_d = (c["kv_lora_rank"], c["qk_rope_head_dim"],
                             c["v_head_dim"])
        pos = torch.arange(t, device=x.device)
        q = a.q_proj(x).view(1, t, h, nope + rope_d)
        q_nope, q_pe = q.split([nope, rope_d], -1)
        ckv, k_pe = a.kv_a_proj_with_mqa(x).split([rank, rope_d], -1)
        kv = a.kv_b_proj(a.kv_a_layernorm(ckv)).view(1, t, h, nope + v_d)
        k_nope, v = kv.split([nope, v_d], -1)
        q_pe = rope(q_pe, pos, c["rope_theta"])
        k_pe = rope(k_pe.view(1, t, 1, rope_d), pos, c["rope_theta"])
        q = torch.cat([q_nope, q_pe], -1)
        k = torch.cat([k_nope, k_pe.expand(1, t, h, rope_d)], -1)
        mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (nope + rope_d) ** -0.5
        o = torch.einsum("bhqk,bkhd->bqhd", (s + mask).softmax(-1), v)
        return a.o_proj(o.reshape(t, h * v_d))

    def _mm(self, x, w):
        if self.precision == "fp8":
            return fp8(fp8(x) @ fp8(w))
        return x @ w

    def experts(self, m: Experts, x):
        """Every routed expert on every token of x (N, D), weighted by the
        router's renormalized top-k (zero for the others), plus the shared
        experts."""
        c = self.cfg
        scores = torch.sigmoid(m.gate_linear(x))
        top = torch.topk(scores + m.gate_bias, c["num_experts_per_tok"],
                         dim=-1).indices
        w = scores.gather(-1, top)
        w = w / w.sum(-1, keepdim=True) * c["routed_scaling_factor"]
        comb = torch.zeros_like(scores).scatter(-1, top, w)
        y = self.dense(m.shared_expert, x)
        for e in range(c["n_routed_experts"]):
            h = F.silu(self._mm(x, m.expert_w1[e])) * self._mm(
                x, m.expert_w3[e])
            y = y + comb[:, e:e + 1] * self._mm(h, m.expert_w2[e])
        return y

    @staticmethod
    def dense(m: Dense, x):
        return m.w2(F.silu(m.w1(x)) * m.w3(x))

    def layer(self, lay: Layer, x):
        """One layer over one sequence x (T, D)."""
        x = self._stream(x + self.attention(lay.self_attn,
                                            lay.input_layernorm(x)))
        y = lay.post_attention_layernorm(x)
        mlp = lay.mlp
        y = self.experts(mlp, y) if isinstance(mlp, Experts) \
            else self.dense(mlp, y)
        return self._stream(x + y)

    def hidden(self, embeds, make_layer):
        """The stack over sequences ``embeds`` [(T_i, D)], one layer at a
        time (``make_layer(li)`` gives layer li with its weights) ->
        [(T_i, D)] normed hidden states."""
        xs = [self._round(e) for e in embeds]
        for li in range(self.cfg["num_hidden_layers"]):
            lay = make_layer(li)
            xs = [self.layer(lay, x) for x in xs]
            del lay
        return [self.norm(x) for x in xs]


class UniSEMoonlightReference(nn.Module):
    """The frozen WavLM, the plain LM's resident part and BiCodec's decoder,
    built from the configuration file's sections; the layers are made by
    ``make_layer`` (module docstring)."""

    def __init__(self, cfg: dict, make_layer):
        super().__init__()
        self.cfg = cfg
        self.sizes = lm_sizes(cfg)
        self.wavlm = Wav2Vec2Model(SSLConfig(**_tuples(cfg["wavlm"])))
        self.lm = LM(self.sizes, cfg["unise"]["feats_dim"])
        self.bicodec = BiCodec(BiCodecConfig(**_tuples(cfg["bicodec"])),
                               tokenize=False)
        self.make_layer = make_layer

    def features(self, wav):
        """(B, N) -> (B, F, 768) WavLM features, as UniSE conditions."""
        return wavlm_features(self.wavlm(F.pad(wav, (160, 160))))

    def code_logits(self, items):
        """Logits of served segments: for each (task, mix wav, enroll wav or
        None, global ids, semantic ids), the reference's prediction for each
        of its G global and T semantic codes from the prompt and the codes
        before it -> [(global logits (G, V), semantic logits (T, V))],
        fp32; the stack runs once over all of them, a layer at a time."""
        v = self.sizes
        lm = self.lm
        g_off, s_off = 3, 3 + v["global_size"]
        embeds, spans = [], []
        for task, mix, enroll, g_ids, s_ids in items:
            dev = mix.device
            ef = None if enroll is None else self.features(enroll[None])[0]
            prompt = lm.prompt(task, ef, self.features(mix[None])[0])
            ids = torch.cat([torch.tensor([0], device=dev),
                             g_ids.long() + g_off,
                             torch.tensor([1], device=dev),
                             s_ids[:-1].long() + s_off])
            embeds.append(torch.cat([prompt, lm.codec_embedding(ids)]))
            spans.append((prompt.shape[0], g_ids.shape[0]))
        out = []
        for h, (n_prompt, n_g) in zip(lm.hidden(embeds, self.make_layer),
                                      spans):
            logits = lm.output_head(h[n_prompt:])
            out.append((logits[:n_g], logits[n_g + 1:]))
        return out

    def detokenize(self, global_ids, semantic_ids):
        """global (B, G), semantic (B, T) -> waveforms (B, T * 320)."""
        return self.bicodec.detokenize(semantic_ids.long(),
                                       global_ids.long()[:, :, None])
