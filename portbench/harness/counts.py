"""Operations and bytes of the work, counted from shapes.

``owner_call`` and ``vq_call`` are copies of ``chip_smoke.py``'s
``owner_bound`` and ``vq_bound`` arithmetic (without the kernels'
arguments): each input byte read once, each output byte written once,
whatever the kernel reads again. ``lm_token_flops`` counts UniSE's LM;
``count_flops`` counts a module's model operations by running it under
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions), with the LSTMs' gate products added from forward hooks,
which that counter does not see.
"""
from __future__ import annotations

from contextlib import ExitStack


def owner_call(tokens: int, slots: int, heads: int, head_dim: int,
               elem_bytes: int):
    """One paged-attention call over every slot (K1): ``tokens`` live K/V
    rows summed over the slots, read once, q and the output of each slot,
    the slot starts and positions; two dot products of the head dimension
    per key and head -> (bytes, operations)."""
    moved = (2 * tokens * heads * head_dim * elem_bytes
             + 2 * slots * heads * head_dim * elem_bytes + 2 * slots * 4)
    return moved, 4 * tokens * heads * head_dim


def vq_call(m: int, n: int, d: int, nq: int):
    """One nq-layer nearest-code search of M rows over N codes of D (K6):
    x and the codebooks read once, the codes written once; 2 M N D
    operations a layer, each at fp32 accuracy as three TF32 products (the
    kernel's 3xTF32 route) -> (bytes, operations at the TF32 peak)."""
    return 4 * (m * d + nq * n * d + m * nq), 3 * 2 * nq * m * n * d


def lm_token_flops(hidden: int, layers: int, vocab: int, context: int,
                   head: bool = True) -> int:
    """Model operations of one token through the LM (Llama block: q, k, v,
    o of D x D, a gated MLP of 4 D, the output head over the vocabulary)
    attending to ``context`` positions: 2 per weight, 4 D per key a
    layer."""
    per_layer = 2 * (4 * hidden * hidden + 3 * hidden * 4 * hidden)
    per_layer += 4 * context * hidden
    return layers * per_layer + (2 * hidden * vocab if head else 0)


def lstm_flops(m, x) -> int:
    """8 H (I + H) per step, layer and direction of ``nn.LSTM`` ``m`` on
    input ``x`` (batch x time steps, in either layout)."""
    steps = x.shape[0] * x.shape[1]
    h = m.hidden_size
    dirs = 2 if m.bidirectional else 1
    total = 0
    for layer in range(m.num_layers):
        i = m.input_size if layer == 0 else h * dirs
        total += steps * dirs * 8 * h * (i + h)
    return total


def count_flops(torch, modules, fn) -> int:
    """Model operations of ``fn()``: FlopCounterMode's count, in which each
    ``nn.LSTM`` of ``modules`` counts as ``lstm_flops`` whatever the counter
    saw inside it (the products of a decomposed CPU LSTM, nothing of
    cuDNN's)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    fix = [0]
    seen = {}

    def pre(m, args):
        seen[id(m)] = counter.get_total_flops()

    def post(m, args, out):
        fix[0] += lstm_flops(m, args[0]) - (counter.get_total_flops()
                                            - seen.pop(id(m)))

    with ExitStack() as stack:
        for mod in modules:
            for m in mod.modules():
                if isinstance(m, torch.nn.LSTM):
                    stack.callback(m.register_forward_pre_hook(pre).remove)
                    stack.callback(m.register_forward_hook(post).remove)
        with counter:
            fn()
    return int(counter.get_total_flops()) + fix[0]
