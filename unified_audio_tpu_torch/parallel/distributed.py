"""Process start-up and hybrid meshes.

Port of ``unified_audio_tpu/parallel/distributed.py``:

* :func:`initialize` joins this process to its process group: from
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``/``MASTER_PORT``) or from explicit arguments. NCCL on a
  CUDA device, gloo only when the caller asks for the CPU; a backend that
  cannot start is an error, never a switch to another one. A single
  process has nothing to join, as in the JAX package.
* :func:`make_hybrid_mesh` builds a named ``DeviceMesh`` whose ``dcn``
  axes span nodes and whose ``ici`` axes span the cards of a node, with
  the JAX package's axis algebra: dcn names first, a name in both
  multiplied, a ``ValueError`` when the sizes do not make the world. On
  GPUs the dcn factor is the node count (``WORLD_SIZE //
  LOCAL_WORLD_SIZE``); ranks are laid out node by node, as ``torchrun``
  numbers them, so the dcn axes vary slowest.
"""
from __future__ import annotations

import os
import warnings
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda",
               timeout: timedelta = DEFAULT_TIMEOUT,
               store: Optional[dist.Store] = None) -> bool:
    """Join the default process group -> whether this process is in one.

    Arguments left None come from ``torchrun``'s environment: the world
    size from ``WORLD_SIZE``, the rank from ``RANK``, the address from
    ``MASTER_ADDR``/``MASTER_PORT`` (``coordinator_address`` is
    "host:port"). Nothing is done for a single process with no address.
    ``store`` rendezvouses through a store the caller made instead of an
    address (e.g. a ``TCPStore`` that rank 0 bound to port 0, so no other
    process can take its port first, and whose port it told the others).
    ``device`` "cuda" starts NCCL on ``cuda:LOCAL_RANK`` (the rank when
    ``LOCAL_RANK`` is not set); "cpu" starts gloo."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes in (None, 1) and coordinator_address is None \
            and store is None:
        return False  # a single process: nothing to join
    if dist.is_initialized():
        return True
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs the world size and the rank "
                         "(num_processes/process_id, or torchrun's "
                         "WORLD_SIZE/RANK)")
    if device == "cuda":
        backend = "nccl"
        local = _env_int("LOCAL_RANK")
        local = process_id if local is None else local
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for NCCL; pass "
                               "device='cpu' to train on the CPU (gloo)")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no card: "
                f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local)
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    kw = dict(backend=backend, world_size=num_processes, rank=process_id,
              timeout=timeout)
    if store is None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    else:
        kw["store"] = store
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kw)
    return True


def device_type() -> str:
    """The mesh device type of the default group's backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def node_count() -> int:
    """Nodes in the job: ``WORLD_SIZE // LOCAL_WORLD_SIZE`` (1 without
    ``torchrun``'s ``LOCAL_WORLD_SIZE``)."""
    local = _env_int("LOCAL_WORLD_SIZE")
    return dist.get_world_size() // local if local else 1


def make_hybrid_mesh(ici: Dict[str, int], dcn: Optional[Dict[str, int]] = None,
                     world_size: Optional[int] = None):
    """``DeviceMesh`` with the ``dcn`` axes across nodes and the ``ici``
    axes within one. ``make_hybrid_mesh(ici=dict(dp=2, tp=4))`` on one node
    is the ici mesh; ``make_hybrid_mesh(ici=dict(dp=1, tp=4),
    dcn=dict(dp=2))`` puts dp across two nodes. A name in both multiplies
    (dp = dp_dcn * dp_ici); the axis order is the dcn names, then the
    ici-only ones. The sizes are checked against ``world_size`` (default
    the default group's) before any group is made."""
    dcn = dict(dcn or {})
    names = list(dcn) + [k for k in ici if k not in dcn]
    ici_shape = [ici.get(k, 1) for k in names]
    dcn_shape = [dcn.get(k, 1) for k in names]
    merged = [d * i for d, i in zip(dcn_shape, ici_shape)]
    total = int(np.prod(merged))
    world = dist.get_world_size() if world_size is None else world_size
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, merged))} needs {total} "
                         f"devices, have {world}")
    n_dcn = int(np.prod(dcn_shape))
    if n_dcn > 1 and n_dcn != node_count():
        warnings.warn(
            "make_hybrid_mesh: the dcn axes span "
            f"{n_dcn} groups but the job has {node_count()} node(s) — "
            "building a placement-unaware mesh; the dcn axes will NOT be "
            "aligned to node boundaries (fine on one node, a performance "
            "bug across nodes)", stacklevel=2)
    # rank = node-major: each (dcn, ici) pair of a shared name collapses
    # into one axis with the dcn factor varying slowest
    ranks = np.arange(total).reshape(dcn_shape + ici_shape)
    order = [a for i in range(len(names)) for a in (i, len(names) + i)]
    ranks = ranks.transpose(order).reshape(merged)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type(), torch.as_tensor(ranks),
                      mesh_dim_names=tuple(names))
