"""Checkpoints of UniSE's SFT training: one ``torch.save`` file a step.

Port of ``unified_audio_tpu/train/checkpoint.py`` (orbax there). A file
holds ``{"state_dict": <the LM in the reference layout>, "optimizer":
<Optimizer.state_dict()>, "step": int}``: only the LM is trained, so the
frozen tokenizer and WavLM are not saved, and ``cli serve --ckpt`` loads
the file as it is. The optimizer state is saved with the weights, so a
resumed run continues the learning-rate schedule and the Adam moments
where they were (the JAX CLI saves the LM weights alone, and a resume
there restarts the warmup from 0). A file is always in the single-device
layout: under a mesh the trainer gathers its tp shards and pp stages,
Adam's moments included, before rank 0 writes, and cuts them again on
load, so a checkpoint written at tp = 2 or pp = 2 resumes at world size 1,
and the reverse.
"""
from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import List, Optional

import torch

from ..parallel.mesh import gather_named, shard_named

_NAME = re.compile(r"^step_(\d+)\.pt$")


def full_training_state(model, optimizer, mesh, num_layers: int):
    """-> (``model``'s state dict, ``optimizer``'s) in the layout a
    single-device run writes: under a mesh the tp shards and pp stages of
    the weights and of the Adam moments are gathered (``parallel/mesh.py
    gather_named``; every rank must call this). Without a mesh, the local
    state as it is."""
    sd, opt = model.state_dict(), optimizer.state_dict()
    if mesh is None:
        return sd, opt
    params = dict(model.named_parameters())
    sd = gather_named(sd, params, mesh, num_layers)
    names = _param_names(model, optimizer)
    # the optimizer's state dict shares its per-parameter dicts with the
    # live state: fill new ones
    state = {i: dict(s) for i, s in opt["adamw"]["state"].items()}
    opt = {**opt, "adamw": {**opt["adamw"], "state": state}}
    for key in ("exp_avg", "exp_avg_sq"):
        named = {names[i]: s[key] for i, s in state.items()}
        whole = gather_named(named, params, mesh, num_layers)
        for i, s in state.items():
            s[key] = whole[names[i]]
    return sd, opt


def load_full_training_state(model, optimizer, sd, opt, mesh,
                             num_layers: int):
    """Load the single-device layout (:func:`full_training_state`'s) into
    ``model`` and ``optimizer``, cut to this rank's shards under a mesh."""
    if mesh is not None:
        params = dict(model.named_parameters())
        sd = shard_named(sd, params, mesh, num_layers)
        names = _param_names(model, optimizer)
        opt = copy.deepcopy(opt)
        state = opt["adamw"]["state"]
        for key in ("exp_avg", "exp_avg_sq"):
            named = {names[i]: s[key] for i, s in state.items()}
            local = shard_named(named, params, mesh, num_layers)
            for i, s in state.items():
                s[key] = local[names[i]]
    model.load_state_dict(sd)
    optimizer.load_state_dict(opt)


def _param_names(model, optimizer):
    """The optimizer's parameter indices -> their names in ``model``."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for p in optimizer.params]


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.pt"

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict):
        """Write ``state`` (``SFTTrainer.state_dict()``) as step ``step``,
        through a temporary file, so that a cut run leaves no half-written
        checkpoint; drop the oldest beyond ``max_to_keep``."""
        tmp = self.path(step).with_suffix(".tmp")
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            self.path(old).unlink()

    def restore(self, step: Optional[int] = None, map_location="cpu"):
        """The checkpoint of ``step`` (default the latest), or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)
