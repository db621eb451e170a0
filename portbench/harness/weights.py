"""Random weights made by the benchmark from ``--seed``, on the device, in
two large draws (one uniform, one normal) sliced into the parameters.

The rule follows the port's seeded initialization in kind: fan-in scaled
uniform weights for linear and conv layers (a weight-normed conv's v, its
g the norm of v), zero biases, LSTM weights uniform in +-1/sqrt(hidden),
unit-normal embeddings and VQ codebooks, Perceiver latents of std 0.02;
norms and the other constructor values stay. The weights are made in the
reference's modules and handed to the program with a strict
``load_state_dict``: both sides hold the same numbers.
"""
from __future__ import annotations

import math


def _plan(torch, module):
    """-> [(tensor, kind, scale)], kind "u" (uniform +-scale), "n" (normal
    of std scale), "0" (zeros) or ("g", v, dims) (the norm of v)."""
    nn = torch.nn
    plan = []
    for m in module.modules():
        cls = type(m).__name__
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)) or cls in (
                "Conv1d", "ConvTranspose1d"):
            wn = getattr(m, "weight_norm", False)
            w = m.weight_v if wn else m.weight
            plan.append((w, "u", 1.0 / math.sqrt(w[0].numel())))
            if wn:
                dims = (0, 2) if cls == "ConvTranspose1d" else (1, 2)
                plan.append((m.weight_g, ("g", w, dims), None))
            if getattr(m, "bias", None) is not None:
                plan.append((m.bias, "0", None))
        elif isinstance(m, nn.Embedding):
            plan.append((m.weight, "n", 1.0))
        elif cls == "VectorQuantization":
            plan.append((m._codebook.embed, "n", 1.0))
        elif cls == "PerceiverResampler":
            plan.append((m.latents, "n", 0.02))
        elif isinstance(m, nn.LSTM):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for name, w in m.named_parameters():
                plan.append((w, "u" if name.startswith("weight") else "0",
                             bound))
    return plan


def fill_(torch, module, generator) -> None:
    """Overwrite ``module``'s weights in place from ``generator`` (on the
    module's device): one uniform and one normal draw for all of them."""
    plan = _plan(torch, module)
    dev = next(module.parameters()).device
    n_u = sum(t.numel() for t, k, _ in plan if k == "u")
    n_n = sum(t.numel() for t, k, _ in plan if k == "n")
    with torch.no_grad():
        uni = torch.rand(n_u, generator=generator, device=dev) * 2 - 1
        nor = torch.randn(n_n, generator=generator, device=dev)
        ou = on = 0
        for t, kind, scale in plan:
            k = t.numel()
            if kind == "u":
                t.copy_(uni[ou:ou + k].view_as(t) * scale)
                ou += k
            elif kind == "n":
                t.copy_(nor[on:on + k].view_as(t) * scale)
                on += k
            elif kind == "0":
                t.zero_()
            else:
                _, v, dims = kind
                t.copy_(v.square().sum(dims, keepdim=True).sqrt())


def hand_over(reference, program) -> None:
    """The reference's weights into the program's module, every key of the
    one matched by the other (a layout that drifted fails here)."""
    program.load_state_dict(reference.state_dict(), strict=True)
