"""Learned UTMOS predictor (the UTMOS column of the H-Codec results table).

Port of ``unified_audio_tpu/eval/utmos.py``: the UTMOS22 strong learner. A
frozen HuBERT-base (the port's ``Wav2Vec2Model``) gives frame features (its
last hidden state); the mean listener (judge) embedding and the domain-0
embedding are broadcast beside them; a bidirectional LSTM
(``nn.LSTM(bidirectional=True)``) and a two-layer MLP give per-frame scores
whose mean is mapped to the 5-point scale (score * 2 + 3).

Weights load from the canonical layout that the JAX package's
``export_utmos_state_dict`` writes and ``convert_utmos`` reads
(``judge_embedding.weight``, ``domain_embedding.weight``,
``blstm.{weight,bias}_{ih,hh}_l0[_reverse]``, ``linear{1,2}.{weight,bias}``)
or from the released UTMOS22 Lightning layout, normalized by
:func:`utmos_head_keys` as ``convert_utmos`` normalizes it. A checkpoint's
``ssl_model.*`` keys are the HuBERT in the HF layout the port takes
(:func:`utmos_ssl_keys`; a weight-normed positional conv is folded).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.ssl.wav2vec2 import Wav2Vec2Model


@dataclass(frozen=True)
class UTMOSConfig:
    ssl_dim: int = 768        # wav2vec2-base hidden
    judge_dim: int = 128
    domain_dim: int = 128
    num_judges: int = 3066    # UTMOS22 BVCC+external listener table
    num_domains: int = 3
    blstm_hidden: int = 512
    mlp_hidden: int = 2048


class UTMOSHead(nn.Module):
    """Everything above the frozen SSL backbone: feats (B, T, ssl_dim) ->
    scores (B,) on the 1-5 MOS scale."""

    def __init__(self, cfg: UTMOSConfig = UTMOSConfig()):
        super().__init__()
        self.cfg = cfg
        self.judge_embedding = nn.Embedding(cfg.num_judges, cfg.judge_dim)
        self.domain_embedding = nn.Embedding(cfg.num_domains,
                                             cfg.domain_dim)
        self.blstm = nn.LSTM(cfg.ssl_dim + cfg.judge_dim + cfg.domain_dim,
                             cfg.blstm_hidden, batch_first=True,
                             bidirectional=True)
        self.linear1 = nn.Linear(2 * cfg.blstm_hidden, cfg.mlp_hidden)
        self.linear2 = nn.Linear(cfg.mlp_hidden, 1)

    def forward(self, feats, judge_id: Optional[int] = None,
                domain_id: int = 0):
        """``judge_id`` None -> the mean listener embedding (the published
        inference recipe)."""
        b, t, _ = feats.shape
        table = self.judge_embedding.weight
        judge = table.mean(0) if judge_id is None else table[judge_id]
        cond = torch.cat([judge, self.domain_embedding.weight[domain_id]])
        x = torch.cat([feats, cond.expand(b, t, -1)], dim=-1)
        x = self.linear2(torch.relu(self.linear1(self.blstm(x)[0])))
        return x[..., 0].mean(-1) * 2.0 + 3.0


class UTMOSPredictor:
    """Frozen SSL backbone + :class:`UTMOSHead`, on the device of their
    weights: ``predictor(wav)`` -> the mean score of the batch."""

    def __init__(self, ssl: Wav2Vec2Model, head: UTMOSHead):
        self.ssl, self.head = ssl.eval(), head.eval()
        self.cfg = head.cfg

    @torch.no_grad()
    def __call__(self, wav: np.ndarray) -> float:
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        device = self.head.linear2.weight.device
        feats = self.ssl(torch.as_tensor(wav, device=device))[-1]
        return float(self.head(feats).mean())


# The released UTMOS22 strong-learner checkpoint's keys (a Lightning module,
# sarulab-speech/UTMOS22 strong/model.py + lightning_module.py), mapped as
# the JAX package's convert_utmos maps them.
_UTMOS22_KEYMAP = {
    "feature_extractors.1.embedding.weight": "domain_embedding.weight",
    "output_layers.0.judge_embedding.weight": "judge_embedding.weight",
    "output_layers.1.net.0.weight": "linear1.weight",
    "output_layers.1.net.0.bias": "linear1.bias",
    "output_layers.1.net.3.weight": "linear2.weight",
    "output_layers.1.net.3.bias": "linear2.bias",
}


def utmos_head_keys(state_dict: Dict) -> Dict:
    """A UTMOS state dict -> the keys of :class:`UTMOSHead`: the prefixes
    "model.", "head.", "mos_predictor." stripped and the UTMOS22 Lightning
    names mapped (``output_layers.0.decoder_rnn.*`` is the BLSTM). Other
    keys pass through unchanged."""
    sd = {}
    for k, v in state_dict.items():
        for pre in ("model.", "head.", "mos_predictor."):
            if k.startswith(pre):
                k = k[len(pre):]
        if k.startswith("output_layers.0.decoder_rnn."):
            k = "blstm." + k[len("output_layers.0.decoder_rnn."):]
        sd[_UTMOS22_KEYMAP.get(k, k)] = v
    return sd


def utmos_ssl_keys(state_dict: Dict) -> Dict:
    """The ``ssl_model.*`` entries of a UTMOS state dict with the prefix
    stripped: the HF-layout HuBERT, its positional conv's weight norm
    (``weight_g``/``weight_v`` or the parametrized ``original0/1``) folded
    into ``weight`` over the axes where g has size 1. Empty if there are
    none."""
    pre = "ssl_model."
    sd = {k[len(pre):]: v for k, v in state_dict.items() if k.startswith(pre)}
    conv = "encoder.pos_conv_embed.conv"
    for g_key, v_key in ((f"{conv}.weight_g", f"{conv}.weight_v"),
                         (f"{conv}.parametrizations.weight.original0",
                          f"{conv}.parametrizations.weight.original1")):
        if g_key in sd:
            g, v = sd.pop(g_key).float(), sd.pop(v_key).float()
            axes = [i for i in range(v.dim()) if g.shape[i] == 1]
            sd[f"{conv}.weight"] = v / v.square().sum(
                axes, keepdim=True).sqrt() * g
    return sd
