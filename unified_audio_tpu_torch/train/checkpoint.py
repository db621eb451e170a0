"""Checkpoints of UniSE's SFT training: one ``torch.save`` file a step.

Port of ``unified_audio_tpu/train/checkpoint.py`` (orbax there). A file
holds ``{"state_dict": <the LM in the reference layout>, "optimizer":
<Optimizer.state_dict()>, "step": int}``: only the LM is trained, so the
frozen tokenizer and WavLM are not saved, and ``cli serve --ckpt`` loads
the file as it is. The optimizer state is saved with the weights, so a
resumed run continues the learning-rate schedule and the Adam moments
where they were (the JAX CLI saves the LM weights alone, and a resume
there restarts the warmup from 0).
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


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
