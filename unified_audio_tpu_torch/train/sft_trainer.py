"""UniSE SFT training on one device: a step is the frozen tokenize and
features, the LM's teacher-forced loss and backward, and one optimizer
update.

Port of ``unified_audio_tpu/train/sft_trainer.py`` without the mesh and
the pipeline: the port trains on one card, as the JAX CLI does when it
sees one device. The LM trains in ``.train()``; the tokenizer and WavLM
stay frozen in ``.eval()``. A step syncs with the host once, to read its
loss and accuracy.
"""
from __future__ import annotations

import torch

from ..models.unise.model import TASK_MAP, UniSE
from .optim import Optimizer


def _to(x, device):
    """A waveform batch (numpy or tensor, or None) as fp32 on ``device``."""
    if x is None:
        return None
    return torch.as_tensor(x).to(device, torch.float32, non_blocking=True)


class SFTTrainer:
    def __init__(self, unise: UniSE, optimizer: Optimizer = None):
        self.unise = unise
        self.sft = unise.sft
        self.optimizer = optimizer or Optimizer(self.sft.parameters())
        self.step = 0

    def device(self) -> torch.device:
        return self.sft.output_head.weight.device

    def loss_backward(self, task: str, frozen):
        """The LM's loss over the frozen inputs, and its gradients ->
        (loss, acc) device scalars."""
        self.sft.train()
        self.optimizer.zero_grad()
        loss, acc = self.sft(TASK_MAP[task], *frozen)
        loss.backward()
        return loss.detach(), acc

    def update(self):
        self.optimizer.step()
        self.step += 1

    def train_step(self, task: str, enroll, mix, target):
        """task in {se, tse, rtse} (enroll None for se); waveforms (B, N),
        numpy or tensors -> (loss, acc) as floats."""
        dev = self.device()
        frozen = self.unise.frozen_inputs(*(_to(x, dev)
                                            for x in (enroll, mix, target)))
        loss, acc = self.loss_backward(task, frozen)
        self.update()
        loss, acc = torch.stack([loss, acc]).cpu().tolist()
        return loss, acc

    def state_dict(self) -> dict:
        """What a checkpoint holds: the LM (the reference layout) under
        "state_dict", the optimizer and schedule, the step."""
        return {"state_dict": self.sft.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, blob: dict):
        self.sft.load_state_dict(blob["state_dict"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.step = blob["step"]


class Validator:
    """Loss and accuracy averaged over validation batches, no update."""

    def __init__(self, unise: UniSE):
        self.unise = unise

    @torch.no_grad()
    def run(self, batches) -> dict:
        """``batches`` of the data iterator's tuples -> averaged
        "valid_loss" and "valid_acc", and "num_batches". Leaves the LM in
        ``.eval()`` (the trainer puts it back in ``.train()`` each step)."""
        sft = self.unise.sft.eval()
        dev = sft.output_head.weight.device
        losses, accs = [], []
        for mode, enroll, mix, speech, interf, *_ in batches:
            target = interf if mode == "rtse" else speech
            loss, acc = self.unise.loss_fn(mode, *(_to(x, dev) for x in (
                enroll, mix, target)))
            losses.append(loss)
            accs.append(acc)
        n = len(losses)
        loss, acc = (torch.stack([torch.stack(losses).sum(),
                                  torch.stack(accs).sum()]).cpu().tolist()
                     if n else (0.0, 0.0))
        return {"valid_loss": loss / max(n, 1), "valid_acc": acc / max(n, 1),
                "num_batches": n}
