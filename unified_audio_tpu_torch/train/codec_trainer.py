"""HCodec GAN training: a step is the generator's update, then the
discriminator's.

Port of ``unified_audio_tpu/train/codec_trainer.py``. The
generator step takes the multi-scale mel L1 (x ``mel_weight``), the
quantizers' commitment loss (x ``commit_weight``) and the semantic feature
L1 (x ``semantic_weight``); from step ``perceptual_start_step`` on it adds
the LSGAN adversarial loss (x ``adv_weight``) and feature matching (x
``fm_weight``) against the discriminator as it was before this step. The
discriminator step then scores the real wav and the generator step's
reconstruction, detached. Each side has its own clipped AdamW at a
constant rate (optax's defaults: weight decay 1e-4). The quantizers' EMA
buffers are updated in the generator's forward, outside the optimizer.
A step reads its scalars back to the host in one transfer.

``mesh`` (a ``DeviceMesh`` with a dp axis, ``parallel/mesh.py``) trains
data-parallel, as the JAX trainer's dp mesh does: every rank holds the
whole generator and discriminator and takes its own share of the batch;
both optimizers average the gradients over dp (one flattened all-reduce
each); the codec's quantizers take their statistics over the whole batch
(``ops/quant.py set_dp_group``), with ``generator`` seeded alike on every
rank; the returned metrics are the dp average. ``cli train-codec`` stays on
one device, as the JAX CLI's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..models.hcodec.codec import HCodec
from ..ops.quant import set_dp_group
from ..parallel.mesh import axis_group, dp_mean
from .discriminators import (CodecDiscriminator, discriminator_loss,
                             feature_matching_loss,
                             generator_adversarial_loss, multiscale_mel_loss)
from .optim import Optimizer

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default

METRICS = ("mel", "commit", "semantic", "adv", "fm", "gen_loss", "disc_loss")


@dataclass
class CodecTrainConfig:
    lr: float = 2e-4
    perceptual_start_step: int = 400_000
    mel_weight: float = 15.0
    commit_weight: float = 1.0
    semantic_weight: float = 1.0
    adv_weight: float = 1.0
    fm_weight: float = 2.0
    grad_clip: float = 5.0
    max_steps: int = 1_000_000


class CodecGANTrainer:
    """Trains ``codec`` (an ``HCodec(trainable=True)``) against ``disc``
    (default the full ensemble on the codec's device). ``generator`` (a
    CPU ``torch.Generator``) draws k-means' rows and the dropout cutoffs.
    ``mesh``: data-parallel training (the module docstring)."""

    def __init__(self, codec: HCodec, train_config: CodecTrainConfig =
                 CodecTrainConfig(), disc: Optional[CodecDiscriminator] = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        self.cfg = train_config
        self.codec = codec
        dev = self.device()
        self.disc = disc if disc is not None else CodecDiscriminator().to(dev)
        self.mesh = mesh
        set_dp_group(codec, axis_group(mesh, "dp"))
        opt = dict(lr=train_config.lr, grad_clip=train_config.grad_clip,
                   weight_decay=ADAMW_WEIGHT_DECAY)
        self.gen_opt = Optimizer(codec.parameters(), **opt)
        self.disc_opt = Optimizer(self.disc.parameters(), **opt)
        self.gen_opt.mesh = self.disc_opt.mesh = mesh
        self.generator = generator or torch.Generator().manual_seed(0)
        self.step = 0

    def device(self) -> torch.device:
        return next(self.codec.parameters()).device

    def generator_loss(self, wav, feat, use_adv: bool):
        """The codec's training forward and its loss -> (loss, the step's
        generator scalars (a dict of device scalars), recon). The EMA
        buffers update here."""
        cfg = self.cfg
        self.codec.train()
        recon, pred_feat, commit = self.codec(wav[..., None], feat, True,
                                              self.generator)
        target = wav[:, :recon.shape[-1]]
        mel = multiscale_mel_loss(target, recon,
                                  self.codec.config.sample_rate)
        semantic = (pred_feat - feat).abs().mean()
        loss = (cfg.mel_weight * mel + cfg.commit_weight * commit
                + cfg.semantic_weight * semantic)
        adv = fm = torch.zeros((), device=wav.device)
        if use_adv:
            # the discriminator's weights take no gradient here
            self.disc.requires_grad_(False)
            fake_scores, fake_feats = self.disc(recon)
            with torch.no_grad():
                _, real_feats = self.disc(target)
            self.disc.requires_grad_(True)
            adv = generator_adversarial_loss(fake_scores)
            fm = feature_matching_loss(real_feats, fake_feats)
            loss = loss + cfg.adv_weight * adv + cfg.fm_weight * fm
        scalars = dict(mel=mel, commit=commit, semantic=semantic, adv=adv,
                       fm=fm, gen_loss=loss)
        return loss, {k: v.detach() for k, v in scalars.items()}, recon

    def generator_step(self, wav, feat, use_adv: bool):
        """Forward, backward and update of the codec -> (the step's
        generator scalars, recon detached)."""
        self.gen_opt.zero_grad()
        loss, scalars, recon = self.generator_loss(wav, feat, use_adv)
        loss.backward()
        self.gen_opt.step()
        return scalars, recon.detach()

    def discriminator_step(self, wav, recon):
        """The LSGAN loss of the real wav against ``recon``, its backward
        and update -> the loss, a device scalar."""
        self.disc_opt.zero_grad()
        real_scores, _ = self.disc(wav[:, :recon.shape[-1]])
        fake_scores, _ = self.disc(recon)
        loss = discriminator_loss(real_scores, fake_scores)
        loss.backward()
        self.disc_opt.step()
        return loss.detach()

    def train_step(self, wav, feat) -> dict:
        """wav (B, T), feat (B, T', feat_dim) on the codec's device (this
        rank's share under a mesh) -> the step's metrics as floats
        (``METRICS``, averaged over dp)."""
        use_adv = self.step >= self.cfg.perceptual_start_step
        scalars, recon = self.generator_step(wav, feat, use_adv)
        scalars["disc_loss"] = (self.discriminator_step(wav, recon)
                                if use_adv else torch.zeros_like(
                                    scalars["mel"]))
        self.step += 1
        values = dp_mean(torch.stack([scalars[k].float() for k in METRICS]),
                         self.mesh).cpu()
        return dict(zip(METRICS, values.tolist()))

    def state_dict(self) -> dict:
        """What a checkpoint holds: the generator (``HCodec``'s training
        state dict, which ``cli codec --ckpt`` loads) under "gen", the
        discriminator under "disc", the step."""
        return {"gen": self.codec.state_dict(),
                "disc": self.disc.state_dict(), "step": self.step}
