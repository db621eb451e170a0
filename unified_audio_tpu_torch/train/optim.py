"""The optimizer of UniSE's SFT training and of codec training: global-norm
gradient clipping, then AdamW under the reference learning-rate schedule
or at a constant rate.

Port of ``unified_audio_tpu/train/optim.py``: a peak rate of 5e-4, a
cosine warmup over 2000 steps, then exponential decay 0.99998^(t - warmup)
floored at 0.02 of the peak; clipping at a global norm of 5.0; AdamW with
decoupled weight decay 0.01 on every parameter (b1 0.9, b2 0.999, eps
1e-8). The JAX package chains optax's ``clip_by_global_norm`` and
``adamw``; this module reproduces their arithmetic:

* the clip scales by ``max_norm / norm`` only when the norm is at least
  ``max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` divides
  by ``norm + 1e-6``);
* the rate of update t (from 0) is ``schedule(t)``, so the first update
  runs at ``schedule(0)``, 0 under the cosine warmup; the schedule is
  evaluated in fp32, as the JAX package evaluates it;
* ``torch.optim.AdamW`` updates p <- p - lr (m_hat / (sqrt(v_hat) + eps) +
  wd p), optax's ``adamw``.

Codec training (``train/codec_trainer.py``) chains the same clip with
optax's ``adamw`` at a constant rate and its default weight decay, 1e-4:
``Optimizer(params, lr=2e-4, weight_decay=1e-4)``.

Under a mesh (``mesh``, a ``DeviceMesh`` of ``parallel/mesh.py``) a step
first averages every gradient over dp, in one flattened all-reduce (what
GSPMD's gradient psum computes in the JAX package; the recorder's
``train.grad_allreduce`` span, once a step), then clips by the
global norm of the whole model: the squared norms of the parameters split
over tp or pp (``mp_split``) are summed over that group and those of the
replicated ones counted once, so every rank clips by the same norm.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import (all_reduce_mean_, axis_group,
                             model_parallel_group, split_params)
from ..utils.profiling import span


def warmup_exp_decay_schedule(peak_lr: float = 5e-4,
                              warmup_steps: int = 2000,
                              step_decay: float = 0.99998,
                              min_factor: float = 0.02):
    """-> schedule(step) -> learning rate (a Python float of an fp32
    value)."""
    f32 = torch.float32

    def schedule(step: int) -> float:
        t = torch.tensor(float(step), dtype=f32)
        warm = 0.5 * (1 + torch.cos(math.pi * (1 - t / warmup_steps)))
        decay = torch.clamp(torch.pow(torch.tensor(step_decay, dtype=f32),
                                      t - warmup_steps), min=min_factor)
        return float(peak_lr * torch.where(t < warmup_steps, warm, decay))

    return schedule


def _sum_squares(grads):
    return sum((g.float().square().sum() for g in grads),
               torch.zeros((), device=grads[0].device) if grads else 0.0)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float, split=(), group=None):
    """Scale ``grads`` and ``split`` in place by ``max_norm / norm`` when
    their global L2 norm is at least ``max_norm`` (on the device: no host
    sync). ``split`` are the gradients of parameters cut over ``group``:
    their squares are summed over it."""
    sq = _sum_squares(list(grads))
    if split:
        part = _sum_squares(list(split))
        if group is not None:
            dist.all_reduce(part, group=group)
        sq = sq + part
    norm = torch.sqrt(sq)
    keep = norm < max_norm
    grads = list(grads) + list(split)
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class Optimizer:
    """Global-norm clip, then AdamW at the schedule's rate, or at ``lr``
    for every update when it is given. The AdamW base rate is 1 and a
    ``LambdaLR`` sets each update's rate to ``schedule(t)`` exactly;
    ``state_dict`` holds both, so a restored optimizer continues the
    schedule and the moments. ``mesh``, which a trainer sets to its own
    before the first step (None by default), averages the gradients over
    its dp axis and clips by the norm of the whole, sharded, model."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 peak_lr: float = 5e-4, warmup_steps: int = 2000,
                 step_decay: float = 0.99998, min_factor: float = 0.02,
                 grad_clip: float = 5.0, weight_decay: float = 0.01,
                 lr: Optional[float] = None):
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip = grad_clip
        self.mesh = None
        self.schedule = (
            warmup_exp_decay_schedule(peak_lr, warmup_steps, step_decay,
                                      min_factor)
            if lr is None else lambda step: lr)
        self.adamw = torch.optim.AdamW(self.params, lr=1.0,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.lr_schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw,
                                                             self.schedule)

    @property
    def lr(self) -> float:
        """The rate of the next update."""
        return self.adamw.param_groups[0]["lr"]

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self):
        """Clip the gradients, update, advance the schedule. A parameter
        the loss did not reach (SE's enrollment SOS) takes a zero gradient,
        as it does in optax: its moments decay and the weight decay
        applies."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with span("train.grad_allreduce"):
            all_reduce_mean_([p.grad for p in self.params],
                             axis_group(self.mesh, "dp"))
        split, rep = split_params(self.params)
        clip_by_global_norm_([p.grad for p in rep], self.grad_clip,
                             [p.grad for p in split],
                             model_parallel_group(self.mesh))
        self.adamw.step()
        self.lr_schedule.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "schedule": self.lr_schedule.state_dict()}

    def load_state_dict(self, state: dict):
        self.adamw.load_state_dict(state["adamw"])
        self.lr_schedule.load_state_dict(state["schedule"])
