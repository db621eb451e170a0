"""Seeded random initialization of the port's modules.

No checkpoint of the released weights is reachable, so serving runs on
random weights made from a seed through an explicit ``torch.Generator``:
fan-in scaled uniform weights for linear and conv layers (a weight-normed
conv's v, its g the norm of v), LSTM weights
uniform in +-1/sqrt(hidden), zero biases, unit-normal embeddings and VQ
codebooks, Perceiver latents normal with std 0.02; the Mimi attention's
fused ``in_proj_weight`` fan-in uniform and the query-token aggregators'
``query_embedding`` unit normal; the routed experts' stacked weights fan-in
uniform per expert (``MoE``'s gate bias zero) and GRVQ's two codebooks unit
normal; norms (BatchNorm statistics too), Snake ``alpha`` and layer scales
keep their constructor values.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..models.bicodec.speaker import PerceiverResampler
from ..models.hcodec.adaptive import QueryTokenAggregator
from ..nn.conv import Conv1d, ConvTranspose1d
from ..nn.mimi import MimiAttention
from ..nn.transformer import MoE
from ..ops.grvq import AutoGroupVectorQuantize
from ..ops.quant import VectorQuantization


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize ``module``'s weights in place from ``generator`` (which
    must live on the parameters' device)."""
    fan_in_types = (nn.Linear, nn.Conv1d, nn.Conv2d, Conv1d, ConvTranspose1d)
    for m in module.modules():
        if isinstance(m, fan_in_types):
            wn = getattr(m, "weight_norm", False)
            w = m.weight_v if wn else m.weight
            bound = 1.0 / math.sqrt(w[0].numel())
            w.uniform_(-bound, bound, generator=generator)
            if wn:  # g = |v| per output channel: the kernel starts as v
                dims = (0, 2) if isinstance(m, ConvTranspose1d) else (1, 2)
                m.weight_g.copy_(w.square().sum(dims, keepdim=True).sqrt())
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, MimiAttention):
            w = m.in_proj_weight
            bound = 1.0 / math.sqrt(w.shape[1])
            w.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, QueryTokenAggregator):
            m.query_embedding.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, PerceiverResampler):
            m.latents.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, VectorQuantization):
            m._codebook.embed.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, MoE):
            for w in (m.expert_w1, m.expert_w3, m.expert_w2):
                bound = 1.0 / math.sqrt(w.shape[1])
                w.uniform_(-bound, bound, generator=generator)
            m.gate_bias.zero_()
        elif isinstance(m, AutoGroupVectorQuantize):
            m.codebook_a.normal_(0.0, 1.0, generator=generator)
            m.codebook_b.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for name, w in m.named_parameters():
                if name.startswith("weight"):
                    w.uniform_(-bound, bound, generator=generator)
                else:
                    w.zero_()
    return module
