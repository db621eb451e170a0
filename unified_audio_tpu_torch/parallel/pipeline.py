"""GPipe pipeline parallelism over the LM's layer stack.

Port of ``unified_audio_tpu/parallel/pipeline.py``: each rank of a ``pp``
mesh axis owns a contiguous block of L/P layers (:func:`shard_stages_`
frees the others), and microbatches flow stage to stage on the classic
GPipe schedule of M + P - 1 ticks (a fill/drain bubble of (P - 1) / (M +
P - 1)). Every rank runs every tick, as the JAX program does under
``shard_map``: stage 0 takes microbatch t (clamped once the drain
begins), the other stages what the tick before sent them, and each tick
ends in one ring permute (rank r to r + 1 mod P). The permute is an
``autograd.Function`` whose backward is the reverse permute, and the
choice between the injected microbatch and the received one is a
``torch.where``, so every rank also runs the same backward, permute for
permute, in the same order (each permute's backward waits for the next
tick's): blocking sends and receives ordered by autograd alone could
deadlock or pair the wrong microbatches.

Gradients: the input's reaches stage 0 only, so the input passes
``copy_to_group`` (its backward sums over pp: the embedding and prompt
gradients then equal the dense ones on every rank); the last stage's
output reaches every rank through ``reduce_from_group`` (an all-reduce of
the last stage's buffer and zeros; its backward is the identity, so the
gradient is not multiplied by P) and the norm and head that follow give
the same gradients on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..nn.transformer import rope_cos_sin
from .mesh import (axis_group, axis_rank, axis_size, copy_to_group,
                   reduce_from_group, stage_layers)

NEG_INF = -1e9


def _ring(tensor, group, shift: int):
    """Send ``tensor`` to the rank ``shift`` ahead on ``group``'s ring and
    return what the rank ``shift`` behind sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(tensor)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, tensor.contiguous(), to, group),
        dist.P2POp(dist.irecv, out, frm, group)])
    for req in reqs:
        req.wait()
    return out


class _RingPermute(torch.autograd.Function):
    """Forward: to the next stage; backward: the gradient to the one
    before (the transpose of a permutation is its inverse)."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _ring(y, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _ring(grad, ctx.group, -1), None


def gpipe(stage_fn, x, *broadcast_args, mesh, n_microbatches: int,
          axis: str = "pp"):
    """Run ``x`` through all the stages, pipelined over ``axis``.

    ``stage_fn(x, *broadcast_args) -> y`` applies this rank's stage (``y``
    has ``x``'s shape); ``x`` (B, ...) enters stage 0, B divisible by
    ``n_microbatches``. Returns the last stage's output, the shape of
    ``x``, on every rank of ``axis``. Other mesh axes are untouched: under
    dp each dp group pipelines its own rows."""
    p_size, group = axis_size(mesh, axis), axis_group(mesh, axis)
    stage = axis_rank(mesh, axis)
    b, m = x.shape[0], n_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible by n_microbatches {m}")
    xs = copy_to_group(x.reshape((m, b // m) + x.shape[1:]), group)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == p_size - 1, device=x.device)
    recv = torch.zeros_like(xs[0])
    outs = []
    ticks = m + p_size - 1
    for t in range(ticks):
        y = stage_fn(torch.where(first, xs[min(t, m - 1)], recv),
                     *broadcast_args)
        if t >= p_size - 1:  # the last stage finishes microbatch t - (P-1)
            outs.append(y)
        if p_size > 1 and t < ticks - 1:
            recv = _RingPermute.apply(y, group)
    # every stage keeps its buffer in the graph (zeros but the last's), so
    # every rank's backward runs the whole schedule
    out = torch.where(last, torch.stack(outs), 0.0)
    return reduce_from_group(out, group).reshape(x.shape)


def shard_stages_(model, mesh, axis: str = "pp"):
    """Keep this rank's block of ``model.layers`` (a ``LlamaBackbone``'s)
    and free the others' weights (they become empty tensors, so the module
    tree and the state dict's keys stay); mark the kept ones ``mp_split``.
    Returns the model."""
    if axis_size(mesh, axis) == 1:
        return model
    start, stop = stage_layers(len(model.layers), mesh, axis)
    with torch.no_grad():
        for i, layer in enumerate(model.layers):
            for p in layer.parameters():
                if not start <= i < stop:
                    p.data = p.data.new_empty(0)
                p.mp_split = True
    return model


def make_llama_stage_fn(backbone, mesh, axis: str = "pp"):
    """This rank's stage of ``backbone``'s layers (L/P of them, the causal
    full forward of training): ``stage_fn(x, mask, cos, sin) -> x``."""
    start, stop = stage_layers(len(backbone.layers), mesh, axis)
    layers = backbone.layers[start:stop]

    def stage_fn(x, mask, cos, sin):
        for layer in layers:
            x = layer(x, mask, cos, sin, None, 0)
        return x

    return stage_fn


def llama_pipeline_forward(backbone, embeds, mesh, n_microbatches: int,
                           axis: str = "pp"):
    """The causal forward of ``backbone``'s layer stack (a
    ``LlamaBackbone``: ``CodecLM``, ``LLMSFT``), pipelined over ``axis``
    -> the hidden states before the final norm (B, S, D), equal to the
    dense layer loop's."""
    cfg = backbone.cfg
    s = embeds.shape[1]
    pos = torch.arange(s, device=embeds.device)
    cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
    mask = torch.where(pos[None] <= pos[:, None], 0.0, NEG_INF)
    return gpipe(make_llama_stage_fn(backbone, mesh, axis), embeds, mask,
                 cos, sin, mesh=mesh, n_microbatches=n_microbatches,
                 axis=axis)


def sft_pipeline_loss(sft, task_id, enroll_feats, mix_feats, global_ids,
                      semantic_ids, mesh, n_microbatches: int,
                      axis: str = "pp"):
    """``LLMSFT.forward`` with its layer stack pipelined over ``axis`` ->
    (loss, acc): the same prompt, ids, final norm, head and label-smoothed
    loss (``SFTTrainer(pp_mesh=)``)."""
    return sft(task_id, enroll_feats, mix_feats, global_ids, semantic_ids,
               stack=lambda e: llama_pipeline_forward(sft, e, mesh,
                                                      n_microbatches, axis))
