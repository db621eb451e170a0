"""CodecLM pretraining: next-token modeling over (global, semantic) BiCodec
token sequences, with optional conditioning embeddings in front.

Port of ``unified_audio_tpu/train/pretrain.py``: ``PretrainTrainer`` with
``train_step`` -> (loss, acc) and ``fit`` over any iterator of (global_ids
(B, Ng), semantic_ids (B, T)[, cond]) batches, such as
``data/token_corpus.py TokenCorpusIterator``. The objective is
``CodecLM.pretrain_loss`` (the final EOS target dropped); the update is
``train/optim.py Optimizer``, optax's clip and AdamW under the reference
schedule, so a step is the JAX package's step. ``mesh`` (dp x tp,
``parallel/mesh.py``) trains as the JAX trainer's mesh does: the LM's
projections cut over tp, each dp rank on its own share of the batch, the
gradients averaged over dp.
"""
from __future__ import annotations

import json
from typing import Iterator, Optional

import torch

from ..models.lm.llama import CodecLM, LlamaConfig
from ..parallel.mesh import dp_mean, shard_lm_
from .optim import Optimizer


class PretrainTrainer:
    """``model`` (a ``CodecLM``, default one of ``cfg`` with random
    weights from ``seed``) on ``device``, the card unless it is "cpu";
    ``optimizer`` defaults to the reference recipe over its parameters.
    ``mesh``: dp x tp training (the module docstring); the weights are cut
    after they are made, so every rank starts from the same model."""

    def __init__(self, cfg: LlamaConfig, model: Optional[CodecLM] = None,
                 optimizer: Optional[Optimizer] = None, device="cuda",
                 seed: int = 0, mesh=None):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; "
                               "PretrainTrainer trains on an NVIDIA card "
                               "unless device='cpu'")
        if model is None:
            from ..utils.initialization import init_random_

            with torch.device(device):
                model = CodecLM(cfg)
            init_random_(model, torch.Generator(device=device).manual_seed(
                seed))
        self.cfg = cfg
        self.model = shard_lm_(model.to(device).train(), mesh)
        self.device = torch.device(device)
        self.mesh = mesh
        self.optimizer = optimizer or Optimizer(self.model.parameters())
        self.optimizer.mesh = mesh
        self.step = 0

    def train_step(self, global_ids, semantic_ids, cond=None):
        """One update on a batch (numpy or tensors; this rank's share under
        a mesh) -> (loss, acc) of the batch before the update, as floats
        (one host read; the dp average under a mesh)."""
        dev = self.device
        g = torch.as_tensor(global_ids).to(dev, non_blocking=True)
        s = torch.as_tensor(semantic_ids).to(dev, non_blocking=True)
        if cond is not None:
            cond = torch.as_tensor(cond).to(dev, non_blocking=True)
        self.optimizer.zero_grad()
        loss, acc = self.model.pretrain_loss(g, s, cond)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        loss, acc = dp_mean(torch.stack([loss.detach(), acc]),
                            self.mesh).cpu().tolist()
        return loss, acc

    def fit(self, data: Iterator, max_steps: Optional[int] = None,
            log_every: int = 50):
        """Train on ``data``'s batches until it ends or ``max_steps``;
        prints a JSON line {"step", "loss", "acc"} every ``log_every``
        steps."""
        for batch in data:
            g, s, cond = batch if len(batch) == 3 else (*batch, None)
            loss, acc = self.train_step(g, s, cond)
            if self.step % log_every == 0:
                print(json.dumps({"step": self.step, "loss": loss,
                                  "acc": acc}), flush=True)
            if max_steps and self.step >= max_steps:
                break
