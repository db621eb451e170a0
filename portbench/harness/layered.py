"""Random weights of an LM too large to hold twice in fp32 (the
``unise_moonlight16b`` configuration: 15 B parameters), made from
``--seed`` one layer at a time.

The rule is ``weights.py``'s (fan-in scaled uniform linear weights, zero
biases, unit-normal embeddings, norms at their constructor values), with
the routed experts' two kinds of parameter added: the stacked expert
weights ``expert_w*`` (E, in, out) fan-in uniform per expert, and the
router's correction bias ``gate_bias`` normal of std 0.02 (a trained
DeepSeek-V3 bias is not zero, and it moves the choice of experts away from
the weighting). Each layer draws from its own generator (salt
``LAYER_SALT + li``), so a layer gets the same numbers whenever it is
made: in set-up, where the reference's fp32 layer is handed to the
program (cast to its dtype), and in the check, where the reference makes
it again. The LM's resident part (embeddings, prompt modules, norm, head)
is filled with WavLM and BiCodec by ``weights.fill_``. The LM's weights
are then rounded to its served dtype (``round_``): the program and the
fp32 reference hold the same numbers, as a checkpoint published in bf16
gives them both.
"""
from __future__ import annotations

import math

from .weights import _plan

LAYER_SALT = 1000


def _layer_plan(torch, module):
    plan = _plan(torch, module)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("expert_w"):
            plan.append((p, "u", 1.0 / math.sqrt(p.shape[1])))
        elif leaf == "gate_bias":
            plan.append((p, "n", 0.02))
    return plan


def fill_(torch, module, generator) -> None:
    """Overwrite ``module``'s weights in place from ``generator`` (on the
    module's device): one uniform and one normal draw for all of them."""
    plan = _layer_plan(torch, module)
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


def round_(torch, module, dtype) -> None:
    """``module``'s weights rounded to ``dtype`` and held as they were:
    the values a checkpoint stored in ``dtype`` holds."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.to(dtype))


def layer_maker(run, sizes: dict, dtype):
    """-> make_layer(li): the reference's fp32 layer ``li`` on the run's
    device, filled from its own generator, its weights rounded to
    ``dtype`` (those of a checkpoint served in that dtype)."""
    torch = run.torch

    def make(li):
        with torch.device(run.device):
            layer = run.reference.Layer(sizes, li)
        fill_(torch, layer, run.generator(LAYER_SALT + li))
        round_(torch, layer, dtype)
        return layer.requires_grad_(False)
    return make


def hand_over(torch, ref, program_lm) -> None:
    """The reference's weights into the program's LM (its storage already
    on the device in its dtype, its values unset): the resident part from
    ``ref.lm``, then each layer made by ``ref.make_layer`` and copied in
    turn; every key of the program's set exactly once (a layout that
    drifted fails here)."""
    make = ref.make_layer
    want = set(program_lm.state_dict())
    got = set()
    with torch.no_grad():
        head = ref.lm.state_dict()
        missing = program_lm.load_state_dict(head, strict=False)
        if missing.unexpected_keys:
            raise KeyError(f"not in the program: {missing.unexpected_keys}")
        got |= set(head)
        for li, layer in enumerate(program_lm.layers):
            sd = make(li).state_dict()
            layer.load_state_dict(sd, strict=True)
            got |= {f"layers.{li}.{k}" for k in sd}
            del sd
    if got != want:
        raise KeyError(f"program keys not handed over: {sorted(want - got)}")
