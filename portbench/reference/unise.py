"""Plain reference of the ``unise`` configuration's serving path.

The WavLM-base-plus frontend (the wav padded by 160 samples a side, the
mean of every layer's output) and BiCodec's decoder are frozen plain copies
(``frozen/``); the LM is written out here: UniSE's prompt [task,
enroll SOS, enroll features, mix SOS, mix features] and a Llama stack
(RMSNorm, GPT-NeoX RoPE, causal softmax attention, gated MLP of 4 D)
teacher-forced over the served codes [global SOS, g, semantic SOS, s], in
full, with no cache, no kernel and no batching across requests. Parameter
names are the port's, so one state dict loads into either.

``precision="fp8"`` is the control, the step below the LM's served bf16:
every tensor the served LM holds in bf16 (the embeddings, the residual
stream, each linear layer's input, weight and output, the logits) rounded
to float8 e4m3 under a per-tensor scale.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .frozen.bicodec import BiCodec, BiCodecConfig
from .frozen.wav2vec2 import (SSLConfig, Wav2Vec2Model, wavlm_features,
                              xlsr_features)

FP8_MAX = 448.0


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Linear(nn.Linear):
    precision = "fp32"

    def forward(self, x):
        if self.precision == "fp8":
            return fp8(F.linear(fp8(x), fp8(self.weight), self.bias))
        return super().forward(x)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * self.weight


def rope(x, positions, theta):
    """GPT-NeoX rotation of x (B, T, H, hd) at ``positions`` (T,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = positions[:, None].float() * inv
    ang = torch.cat([ang, ang], -1)[None, :, None]
    x1, x2 = x.chunk(2, -1)
    return x * ang.cos() + torch.cat([-x2, x1], -1) * ang.sin()


class Attention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = (
            Linear(d, d, bias=False) for _ in range(4))


class MLP(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.gate_proj = Linear(d, 4 * d, bias=False)
        self.up_proj = Linear(d, 4 * d, bias=False)
        self.down_proj = Linear(4 * d, d, bias=False)


class Layer(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.self_attn = Attention(d)
        self.mlp = MLP(d)
        self.input_layernorm = RMSNorm(d)
        self.post_attention_layernorm = RMSNorm(d)


class LM(nn.Module):
    """UniSE's LM: parameters named as the port's ``LLMSFT``."""

    def __init__(self, lm: dict, feats_dim: int, num_tasks: int = 3):
        super().__init__()
        d = lm["hidden_size"]
        self.cfg = lm
        self.vocab = 3 + lm["global_size"] + lm["semantic_size"]
        self.codec_embedding = nn.Embedding(self.vocab, d)
        self.layers = nn.ModuleList(Layer(d) for _ in range(lm["num_layers"]))
        self.norm = RMSNorm(d)
        self.output_head = Linear(d, self.vocab, bias=False)
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

    def prompt(self, task, enroll_feats, mix_feats):
        """One request: feats (T, F) -> (T_prompt, D)."""
        dev = mix_feats.device
        parts = [self.task_embedding(torch.tensor([task], device=dev))]
        if enroll_feats is not None:
            parts += [self.enroll_sos_embedding.weight,
                      self.adapter(enroll_feats)]
        parts += [self.mix_sos_embedding.weight, self.adapter(mix_feats)]
        return torch.cat(parts)

    def logits(self, embeds):
        """(T, D) -> (T, V): the causal stack over one sequence."""
        lm = self.cfg
        h, hd = lm["num_heads"], lm["hidden_size"] // lm["num_heads"]
        t = embeds.shape[0]
        pos = torch.arange(t, device=embeds.device)
        mask = torch.full((t, t), float("-inf"), device=embeds.device).triu(1)
        x = self._round(embeds[None])
        for layer in self.layers:
            a = layer.self_attn
            y = layer.input_layernorm(x)
            q, k, v = (p(y).view(1, t, h, hd) for p in
                       (a.q_proj, a.k_proj, a.v_proj))
            q, k = rope(q, pos, lm["rope_theta"]), rope(k, pos,
                                                         lm["rope_theta"])
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd) + mask
            o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
            x = self._round(x + a.o_proj(o.reshape(1, t, -1)))
            m = layer.mlp
            y = layer.post_attention_layernorm(x)
            x = self._round(x + m.down_proj(F.silu(m.gate_proj(y))
                                            * m.up_proj(y)))
        return self.output_head(self.norm(x))[0]


class UniSEReference(nn.Module):
    """The frozen WavLM, the plain LM and BiCodec's decoder, built from the
    configuration file's sections; with ``tokenize`` (training) also
    XLSR-53 and BiCodec's tokenize side."""

    def __init__(self, cfg: dict, tokenize: bool = False):
        super().__init__()
        self.cfg = cfg
        self.wavlm = Wav2Vec2Model(SSLConfig(**_tuples(cfg["wavlm"])))
        self.lm = LM(cfg["lm"], cfg["unise"]["feats_dim"])
        self.bicodec = BiCodec(BiCodecConfig(**_tuples(cfg["bicodec"])),
                               tokenize=tokenize)
        if tokenize:
            self.xlsr = Wav2Vec2Model(SSLConfig(**_tuples(cfg["xlsr"])))

    def frozen_inputs(self, enroll, mix, target):
        """The frozen half of a training step: BiCodec's tokens of
        ``target`` (XLSR-53 features of the normalized wav; the speaker
        branch on the first 6 s, tiled when shorter) and the WavLM features
        of ``mix`` and ``enroll`` -> (enroll feats or None, mix feats,
        global (B, G), semantic (B, T))."""
        b = self.cfg["bicodec"]
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, correction=0)
        feat = xlsr_features(self.xlsr((target - mean) / torch.sqrt(
            var + 1e-7)))
        hop = b["latent_hop_length"]
        ref_len = int(b["sample_rate"] * b["ref_segment_duration"]) \
            // hop * hop
        ref = target
        if ref_len > ref.shape[-1]:
            ref = ref.repeat(1, ref_len // ref.shape[-1] + 1)
        semantic, global_ = self.bicodec.tokenize(feat, ref[:, :ref_len])
        enroll_feats = None if enroll is None else self.features(enroll)
        return enroll_feats, self.features(mix), global_[:, :, 0], semantic

    def sft_loss(self, task, enroll_feats, mix_feats, global_ids,
                 semantic_ids):
        """UniSE's SFT loss over a batch: each row's prompt and codes [gSOS
        g sSOS s] against [g sSOS s sEOS], label-smoothed KL in closed form,
        averaged over every target of the batch."""
        lm = self.cfg["lm"]
        dev = mix_feats.device
        v, eps = self.lm.vocab, lm["label_smoothing"]
        fill, conf = eps / (v - 1), 1.0 - eps
        const = (v - 1) * fill * math.log(fill) + conf * math.log(conf)
        g_off, s_off = 3, 3 + lm["global_size"]
        total, count = 0.0, 0
        for b in range(mix_feats.shape[0]):
            g = global_ids[b].long() + g_off
            s = semantic_ids[b].long() + s_off
            one = torch.ones(1, dtype=torch.long, device=dev)
            ids = torch.cat([0 * one, g, one, s])
            target = torch.cat([g, one, s, 2 * one])
            prompt = self.lm.prompt(task, None if enroll_feats is None
                                    else enroll_feats[b], mix_feats[b])
            logits = self.lm.logits(torch.cat(
                [prompt, self.lm.codec_embedding(ids)]))[-target.shape[0]:]
            logp = torch.log_softmax(logits, -1)
            kl = (const - fill * logp.sum(-1)
                  - (conf - fill) * logp.gather(1, target[:, None])[:, 0])
            total = total + kl.sum()
            count += target.shape[0]
        return total / count

    def features(self, wav):
        """(B, N) -> (B, F, 768) WavLM features, as UniSE conditions."""
        return wavlm_features(self.wavlm(F.pad(wav, (160, 160))))

    def code_logits(self, task, mix_wav, enroll_wav, global_ids,
                    semantic_ids):
        """Logits of one served segment: the reference's prediction for
        each of its G global and T semantic codes, from the prompt and the
        codes before it -> (global logits (G, V), semantic logits (T, V)),
        fp32."""
        lm = self.cfg["lm"]
        dev = mix_wav.device
        enroll = (None if enroll_wav is None
                  else self.features(enroll_wav[None])[0])
        prompt = self.lm.prompt(task, enroll, self.features(mix_wav[None])[0])
        g_off, s_off = 3, 3 + lm["global_size"]
        ids = torch.cat([torch.tensor([0], device=dev),
                         global_ids.long() + g_off,
                         torch.tensor([1], device=dev),
                         semantic_ids[:-1].long() + s_off])
        out = self.lm.logits(torch.cat([prompt,
                                        self.lm.codec_embedding(ids)]))
        out = out[prompt.shape[0]:]
        n_g = global_ids.shape[0]
        return out[:n_g], out[n_g + 1:]

    def detokenize(self, global_ids, semantic_ids):
        """global (B, G), semantic (B, T) -> waveforms (B, T * 320)."""
        return self.bicodec.detokenize(semantic_ids.long(),
                                       global_ids.long()[:, :, None])


def gaps(global_logits, semantic_logits, global_ids, semantic_ids, lm: dict,
         pick=None):
    """How far below the best code of its range (the phase's vocabulary) each
    served code's reference logit lies -> (G + T,) fp32; a code outside its
    range reads inf. ``pick`` (a second pair of logits) replaces the served
    codes by the codes those logits put first: the control's reading."""
    sizes = (lm["global_size"], lm["semantic_size"])
    offs = (3, 3 + lm["global_size"])
    out = []
    for logits, ids, off, size, alt in zip(
            (global_logits, semantic_logits), (global_ids, semantic_ids),
            offs, sizes, pick or (None, None)):
        x = logits[:, off:off + size]
        if alt is not None:
            ids = alt[:, off:off + size].argmax(-1)
        ids = ids.long()
        inside = (ids >= 0) & (ids < size)
        got = x.gather(1, ids.clamp(0, size - 1)[:, None])[:, 0]
        gap = x.max(-1).values - got
        out.append(torch.where(inside, gap, torch.full_like(gap,
                                                            float("inf"))))
    return torch.cat(out)


def support_gaps(global_logits, semantic_logits, global_ids, semantic_ids,
                 lm: dict, top_k: int, top_p: float, pick=None):
    """How far below the least code of the reference's sampling support
    each served code's reference logit lies, 0 inside it -> (G + T,) fp32;
    a code outside its range reads inf. The support, in the phase's range:
    the top ``top_k`` logits, cut to the shortest head of them whose
    softmax (over those k, before any temperature) reaches ``top_p``, ties
    with its least logit kept. ``pick`` (a second pair of logits, a
    temperature and a generator) replaces the served codes by codes drawn
    from those logits' own support at that temperature: the control's
    reading."""
    sizes = (lm["global_size"], lm["semantic_size"])
    offs = (3, 3 + lm["global_size"])
    alts = (None, None) if pick is None else pick[:2]
    out = []
    for logits, ids, off, size, alt in zip(
            (global_logits, semantic_logits), (global_ids, semantic_ids),
            offs, sizes, alts):
        x = logits[:, off:off + size]
        if alt is not None:
            a = alt[:, off:off + size]
            a = torch.where(a < _least_kept(a, top_k, top_p)[:, None],
                            -torch.inf, a)
            ids = torch.multinomial(torch.softmax(a / pick[2], -1), 1,
                                    generator=pick[3])[:, 0]
        ids = ids.long()
        inside = (ids >= 0) & (ids < size)
        got = x.gather(1, ids.clamp(0, size - 1)[:, None])[:, 0]
        gap = (_least_kept(x, top_k, top_p) - got).clamp(min=0)
        out.append(torch.where(inside, gap, torch.full_like(gap,
                                                            float("inf"))))
    return torch.cat(out)


def _least_kept(x, top_k: int, top_p: float):
    """(N, V) logits -> (N,) the least logit of each row's support."""
    vals = torch.topk(x, min(top_k, x.shape[-1]), dim=-1).values
    cum = torch.cumsum(torch.softmax(vals, -1), -1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] <= top_p], -1)
    return torch.where(keep, vals, torch.inf).amin(-1)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
