"""Named meshes, the LM's tensor-parallel sharding, and the collectives
autograd runs through.

Port of ``unified_audio_tpu/parallel/mesh.py``. The JAX package annotates
parameters with ``PartitionSpec`` rules and GSPMD inserts the collectives;
here a rank keeps only its slice of a sharded parameter and the forward
calls the collectives itself, in Megatron's pattern:

* column-parallel projections (``self_attn.{q,k,v}_proj``,
  ``mlp.{gate,up}_proj``: JAX's fused ``qkv_proj`` / ``gate_up_proj``) keep
  rows ``[r * out/tp, (r + 1) * out/tp)`` of their ``(out, in)`` weight, so
  a tp rank computes H/tp whole heads and 4D/tp MLP channels; their input
  passes :func:`copy_to_group` (forward identity, backward all-reduce);
* row-parallel projections (``self_attn.o_proj``, ``mlp.down_proj``) keep
  the matching columns, and their partial output passes
  :func:`reduce_from_group` (forward all-reduce, backward identity);
* ``output_head`` keeps a slice of the vocabulary and ``codec_embedding`` a
  slice of the hidden width, as JAX shards them; their outputs pass
  :func:`gather_from_group` (forward all-gather of the last dim, backward
  the local slice).

A dimension the axis does not divide stays replicated, as in JAX
(``mesh.py:80-88`` there): the head's 12,291-entry vocabulary (131 in the
tests' tiny LM) is not split at tp = 2 or 4.

Expert parallelism: the routed ``MoE``'s stacked ``expert_w{1,2,3}`` keep
E / tp experts a rank (their expert axis cut over tp, as JAX's
``expert_w`` rule cuts it); the MoE sums its ranks' partial outputs over the
group (``nn/transformer.py MoE``). ``EXPERT_RULES`` is that rule alone,
for models whose attention is not tensor-parallel (HCodec's hybrid
``Transformer``, whose ``self_attn.q_proj`` the LM rules would cut).

A rank's data is its dp coordinate's (:func:`dp_shard`); tp and pp peers
take the batches their group's first rank draws (:func:`share_batches`).

Gradients are reduced explicitly, once a step: :func:`all_reduce_mean_`
flattens them into one buffer, sums it over dp and divides by dp (GSPMD's
gradient psum). A sharded parameter carries ``tp_dim`` (the dimension it
is cut along) and ``mp_split`` (its entries are a part of the whole that
the other model-parallel ranks hold the rest of), which the global-norm
clip (``train/optim.py``) and the checkpoint gather read.
"""
from __future__ import annotations

import re
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES_MP = ("tp", "pp")  # the model-parallel axes a parameter may be split on


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def make_mesh_axes(**axes):
    """``DeviceMesh`` with the named axes in keyword order (earlier axes
    vary slowest over the ranks), e.g. ``make_mesh_axes(dp=2, pp=2)``; the
    sizes must multiply to the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import device_type

    n = int(np.prod(list(axes.values())))
    if n != dist.get_world_size():
        raise ValueError(f"mesh {axes} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type(), tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def make_mesh(dp: Optional[int] = None, tp: int = 1):
    """The (dp, tp) mesh over the world; dp defaults to world // tp."""
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide the world of {n}")
        dp = n // tp
    return make_mesh_axes(dp=dp, tp=tp)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name``: 1 without a mesh or without the axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 without it)."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of axis ``name``, or None where the mesh lacks the
    axis. An axis of size 1 has its group too: a world-1 run goes through
    the collectives a larger one runs."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(name)


def model_parallel_group(mesh):
    """The group a parameter's shards are spread over: tp's or pp's (a mesh
    has at most one of them above 1), or None."""
    for name in AXES_MP:
        if axis_size(mesh, name) > 1:
            return axis_group(mesh, name)
    return None


def stage_layers(num_layers: int, mesh, axis: str = "pp"):
    """-> (start, stop): the contiguous block of ``num_layers`` layers this
    rank's pipeline stage owns."""
    p = axis_size(mesh, axis)
    if num_layers % p:
        raise ValueError(f"num_layers {num_layers} not divisible by "
                         f"{axis}={p}")
    n = num_layers // p
    r = axis_rank(mesh, axis)
    return r * n, (r + 1) * n


def shard_batch(x, mesh):
    """This rank's dp share of a global batch (rows ``[r * B/dp, (r + 1) *
    B/dp)``, r the dp coordinate); tp and pp peers get the same rows. None
    passes through."""
    dp = axis_size(mesh, "dp")
    if x is None or dp == 1:
        return x
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} is not divisible by dp={dp}")
    n = x.shape[0] // dp
    r = axis_rank(mesh, "dp")
    return x[r * n:(r + 1) * n]


def dp_shard(mesh):
    """-> (index, count) of this rank's share of the data: its dp
    coordinate and the dp size (what the data iterators take as
    ``process_index`` / ``process_count``)."""
    return axis_rank(mesh, "dp"), axis_size(mesh, "dp")


def share_batches(batches, mesh):
    """Yield ``batches`` so that the ranks of each model-parallel group (the
    tp or pp peers of one dp coordinate) get the same ones, whatever the
    loader's worker threads did: the group's first rank draws each batch
    from ``batches`` and broadcasts it, tensors on their device and the
    other fields (the task, names, None) as objects; its peers never
    iterate ``batches``. The first rank's end of ``batches`` ends them
    all. Without a model-parallel axis above 1, ``batches`` as it is."""
    group = model_parallel_group(mesh)
    if group is None:
        yield from batches
        return
    src = dist.get_global_rank(group, 0)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    drawn = iter(batches) if dist.get_rank() == src else None
    while True:
        batch = None if drawn is None else next(drawn, None)
        head = [None if batch is None else [
            ("tensor", tuple(x.shape), x.dtype)
            if isinstance(x, torch.Tensor) else ("object", x)
            for x in batch]]
        dist.broadcast_object_list(head, src=src, group=group, device=device)
        if head[0] is None:
            return
        out = []
        for i, (kind, *spec) in enumerate(head[0]):
            if kind == "object":
                out.append(spec[0])
                continue
            x = (batch[i].contiguous() if batch is not None
                 else torch.empty(spec[0], dtype=spec[1], device=device))
            dist.broadcast(x, src=src, group=group)
            out.append(x)
        yield tuple(out)


# ---------------------------------------------------------------------------
# Collectives autograd runs through
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Forward identity, backward all-reduce: the input of a
    column-parallel layer, whose gradient each rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward all-reduce, backward identity: the partial output of a
    row-parallel layer. Every rank then holds the whole output and the
    whole gradient of it, so the backward must not reduce again (that
    would multiply the gradient by the group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    """Forward all-gather of the last dim in rank order, backward this
    rank's slice of the (whole, identical on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return unshard_tensor(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        r, w = dist.get_rank(ctx.group), ctx.width
        return grad[..., r * w:(r + 1) * w].contiguous(), None


def copy_to_group(x, group):
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group):
    return x if group is None else _GatherFromGroup.apply(x, group)


def dp_mean(values, mesh):
    """A tensor of per-rank scalars (a step's loss and accuracy) averaged
    over the mesh's dp axis: the global batch's, on every rank."""
    group = axis_group(mesh, "dp")
    if group is not None:
        values = values.clone()
        dist.all_reduce(values, group=group)
        values = values / axis_size(mesh, "dp")
    return values


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group):
    """Average ``tensors`` over ``group`` in place through one flattened
    buffer: sum, then divide by the group's size."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


# ---------------------------------------------------------------------------
# The LM's tensor-parallel sharding
# ---------------------------------------------------------------------------

# parameter name (the reference layout) -> the dim of the torch weight that
# is cut over tp; everything unmatched is replicated. nn.Linear weights are
# (out, in): column-parallel cuts dim 0, row-parallel dim 1.
EXPERT_RULES: Sequence = (
    (r"(.*\.)?expert_w\d", 0),  # stacked (E, in, out) over E
)
LM_RULES: Sequence = (
    (r"(.*\.)?self_attn\.[qkv]_proj\.weight", 0),
    (r"(.*\.)?self_attn\.o_proj\.weight", 1),
    (r"(.*\.)?mlp\.(gate|up)_proj\.weight", 0),
    (r"(.*\.)?mlp\.down_proj\.weight", 1),
    (r"(.*\.)?output_head\.weight", 0),  # JAX (D, V) over V
    (r"(.*\.)?codec_embedding\.weight", 1),  # JAX (V, D) over D
    *EXPERT_RULES,
)


def tp_dim_for(name: str, shape, tp: int, rules=LM_RULES) -> Optional[int]:
    """The dim ``name``'s weight is cut along at ``tp``, or None
    (replicated: no rule, tp = 1, or a dim tp does not divide)."""
    if tp == 1:
        return None
    for pattern, dim in rules:
        if re.fullmatch(pattern, name):
            return dim if shape[dim] % tp == 0 else None
    return None


@torch.no_grad()
def shard_lm_(model: torch.nn.Module, mesh, rules=LM_RULES):
    """Cut ``model``'s (a ``CodecLM`` or ``LLMSFT``; with ``EXPERT_RULES``
    any model with routed experts) tp-sharded weights to this rank's
    slice, in place (the ``Parameter`` objects stay, so an
    optimizer made over them before still holds them; it must not have
    stepped yet), and hand the tp group to the modules whose forward
    calls the collectives. Returns the model. A no-op at tp = 1."""
    tp, group = axis_size(mesh, "tp"), axis_group(mesh, "tp")
    if tp == 1:
        return model
    r = axis_rank(mesh, "tp")
    for name, p in model.named_parameters():
        dim = tp_dim_for(name, p.shape, tp, rules)
        if dim is None:
            continue
        n = p.shape[dim] // tp
        p.data = p.data.narrow(dim, r * n, n).contiguous()
        p.tp_dim, p.mp_split = dim, True
    for module in model.modules():
        if hasattr(module, "tp_group"):
            module.tp_group = group
    return model


def unshard_tensor(x, dim: int, group):
    """The whole tensor of which each rank of ``group`` holds the slice
    along ``dim`` (in rank order)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def shard_tensor(x, dim: int, mesh):
    """This rank's tp slice of ``x`` along ``dim``."""
    n = x.shape[dim] // axis_size(mesh, "tp")
    return x.narrow(dim, axis_rank(mesh, "tp") * n, n).contiguous()


def split_params(params: Iterable[torch.nn.Parameter]):
    """-> (the parameters split over the model-parallel group, the
    replicated ones)."""
    split, rep = [], []
    for p in params:
        (split if getattr(p, "mp_split", False) else rep).append(p)
    return split, rep


_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def gather_named(named: dict, params: dict, mesh, num_layers: int) -> dict:
    """The whole tensors of ``named`` (name -> this rank's tensor: a
    parameter's value or a moment of the same layout), in the reference
    layout: the tp slices of each parameter with ``tp_dim`` all-gathered
    in rank order, and under pp each stage's block of ``layers.{i}.*``
    gathered from its owner. ``params`` maps the names to the parameters
    (their ``tp_dim``); names outside it pass through. Every rank of the
    mesh must call it (collectives); every rank gets the whole."""
    out = dict(named)
    tp_group = axis_group(mesh, "tp")
    if axis_size(mesh, "tp") > 1:
        for name, t in named.items():
            dim = getattr(params.get(name), "tp_dim", None)
            if dim is not None:
                out[name] = unshard_tensor(t, dim, tp_group)
    pp_group = axis_group(mesh, "pp")
    if axis_size(mesh, "pp") > 1:
        start, stop = stage_layers(num_layers, mesh, "pp")
        n = stop - start
        for name in list(out):
            m = _LAYER.match(name)
            if m is None or not start <= int(m.group(1)) < stop:
                continue
            j = int(m.group(1)) - start
            parts = [torch.empty_like(out[name])
                     for _ in range(dist.get_world_size(pp_group))]
            dist.all_gather(parts, out[name].contiguous(), group=pp_group)
            for stage, t in enumerate(parts):
                out[f"layers.{stage * n + j}.{m.group(2)}"] = t
    return out


def shard_named(named: dict, params: dict, mesh, num_layers: int) -> dict:
    """The inverse of :func:`gather_named`: this rank's tp slice of each
    parameter with ``tp_dim``, and under pp empty tensors for the layers
    of the other stages."""
    out = {}
    start, stop = stage_layers(num_layers, mesh, "pp")
    pp = axis_size(mesh, "pp") > 1
    for name, t in named.items():
        dim = getattr(params.get(name), "tp_dim", None)
        if dim is not None:
            t = shard_tensor(t, dim, mesh)
        m = _LAYER.match(name)
        if pp and m is not None and not start <= int(m.group(1)) < stop:
            t = t.new_empty(0)
        out[name] = t
    return out
