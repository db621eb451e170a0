"""UniSE SFT training: a step is the frozen tokenize and features, the LM's
teacher-forced loss and backward, and one optimizer update.

Port of ``unified_audio_tpu/train/sft_trainer.py``. The LM trains in
``.train()``; the tokenizer and WavLM stay frozen in ``.eval()``. A step
syncs with the host once, to read its loss and accuracy.

Parallel training, as in the JAX trainer, takes one of two meshes
(``parallel/mesh.py``), never both:

* ``mesh`` (dp x tp): the LM's projections are cut over tp
  (``shard_lm_``); tp peers must be given the same batch (a loader's
  threads make two iterators of one seed differ: ``cli train-unise``
  hands them one rank's batches through ``share_batches``), dp ranks
  different ones;
* ``pp_mesh`` (dp x pp): the layer stack runs through the GPipe schedule
  over pp in ``pp_microbatches`` microbatches (``parallel/pipeline.py``),
  each rank holding its stage's layers.

Under either, ``train_step`` takes this rank's share of the batch (what
the data iterator of its dp coordinate yields, or ``shard_batch`` of a
global batch); the frozen tokenize and features run on that share; the
optimizer averages the gradients over dp and clips by the norm of the
whole model; the returned loss and accuracy are the dp average, the
global batch's. Gradients are reduced explicitly rather than through
``DistributedDataParallel``, the same way for every trainer (the codec's
GAN step calls its discriminator more than once before a backward).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.unise.model import TASK_MAP, UniSE
from ..parallel.mesh import axis_group, dp_mean, shard_lm_
from ..utils.profiling import span
from .checkpoint import full_training_state, load_full_training_state
from .optim import Optimizer


def _to(x, device):
    """A waveform batch (numpy or tensor, or None) as fp32 on ``device``."""
    if x is None:
        return None
    return torch.as_tensor(x).to(device, torch.float32, non_blocking=True)


class SFTTrainer:
    def __init__(self, unise: UniSE, optimizer: Optimizer = None, mesh=None,
                 pp_mesh=None, pp_microbatches: int = 2):
        if mesh is not None and pp_mesh is not None:
            raise ValueError("pass either mesh (dp/tp) or pp_mesh, not both")
        self.unise = unise
        self.sft = unise.sft
        self.mesh = mesh if mesh is not None else pp_mesh
        self.pp_mesh = pp_mesh
        self.pp_microbatches = pp_microbatches
        if mesh is not None:
            shard_lm_(self.sft, mesh)
        if pp_mesh is not None:
            from ..parallel.pipeline import shard_stages_

            shard_stages_(self.sft, pp_mesh)
        self.optimizer = optimizer or Optimizer(self.sft.parameters())
        self.optimizer.mesh = self.mesh
        self.step = 0

    def device(self) -> torch.device:
        return self.sft.output_head.weight.device

    def lm_loss(self, task: str, frozen):
        """The LM's loss and accuracy over the frozen inputs (the layer
        stack pipelined under ``pp_mesh``)."""
        if self.pp_mesh is None:
            return self.sft(TASK_MAP[task], *frozen)
        from ..parallel.pipeline import sft_pipeline_loss

        return sft_pipeline_loss(self.sft, TASK_MAP[task], *frozen,
                                 self.pp_mesh, self.pp_microbatches)

    def loss_backward(self, task: str, frozen):
        """The LM's loss over the frozen inputs, and its gradients ->
        (loss, acc) device scalars."""
        with span("train.loss_backward"):
            self.sft.train()
            self.optimizer.zero_grad()
            loss, acc = self.lm_loss(task, frozen)
            loss.backward()
            return loss.detach(), acc

    def update(self):
        with span("train.update"):
            self.optimizer.step()
            self.step += 1

    def train_step(self, task: str, enroll, mix, target):
        """task in {se, tse, rtse} (enroll None for se); waveforms (B, N),
        numpy or tensors, this rank's share under a mesh -> (loss, acc) as
        floats, averaged over dp."""
        with span("train.step", task=task):
            dev = self.device()
            frozen = self.unise.frozen_inputs(*(_to(x, dev) for x in (
                enroll, mix, target)))
            loss, acc = self.loss_backward(task, frozen)
            self.update()
            loss, acc = dp_mean(torch.stack([loss, acc]), self.mesh).cpu()
            return loss.item(), acc.item()

    def state_dict(self) -> dict:
        """What a checkpoint holds: the LM (the reference layout, whole
        under a mesh) under "state_dict", the optimizer and schedule, the
        step. Under a mesh every rank must call it (it gathers)."""
        sd, opt = full_training_state(self.sft, self.optimizer, self.mesh,
                                      self.sft.cfg.num_layers)
        return {"state_dict": sd, "optimizer": opt, "step": self.step}

    def load_state_dict(self, blob: dict):
        load_full_training_state(self.sft, self.optimizer, blob["state_dict"],
                                 blob["optimizer"], self.mesh,
                                 self.sft.cfg.num_layers)
        self.step = blob["step"]


class Validator:
    """Loss and accuracy averaged over validation batches, no update. With
    ``mesh`` (dp x tp) every rank scores its own batches and the sums of
    loss, accuracy and batch count are all-reduced over dp. The forward is
    the LM's own: a pipelined LM (``pp_mesh``) is not validated, as in the
    JAX package."""

    def __init__(self, unise: UniSE, mesh=None):
        self.unise = unise
        self.mesh = mesh

    @torch.no_grad()
    def run(self, batches) -> dict:
        """``batches`` of the data iterator's tuples -> averaged
        "valid_loss" and "valid_acc", and "num_batches". Leaves the LM in
        ``.eval()`` (the trainer puts it back in ``.train()`` each step)."""
        sft = self.unise.sft.eval()
        dev = sft.output_head.weight.device
        sums = torch.zeros(3, device=dev, dtype=torch.float64)
        for mode, enroll, mix, speech, interf, *_ in batches:
            target = interf if mode == "rtse" else speech
            loss, acc = self.unise.loss_fn(mode, *(_to(x, dev) for x in (
                enroll, mix, target)))
            sums += torch.stack([loss.double(), acc.double(),
                                 torch.ones((), device=dev,
                                            dtype=torch.float64)])
        group = axis_group(self.mesh, "dp")
        if group is not None:
            dist.all_reduce(sums, group=group)
        loss, acc, n = sums.cpu().tolist()
        n = int(n)
        return {"valid_loss": loss / max(n, 1), "valid_acc": acc / max(n, 1),
                "num_batches": n}
