"""Training a causal HCodec in the port (``unified_audio_tpu_torch``)
against the JAX package on the CPU, at tiny sizes:
``HCodec(causal=True, trainable=True).forward(train=True)`` for 1.0 and
2.0 (the loss, the EMA buffers and every gradient, with JAX's k-means
rows and dropout cutoffs), and ``cli train-codec --device cpu`` with
``codec: {causal: true}``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_causal import causal10, causal20
from test_torch_codec_train import (HCODEC_GRAD_TOL, batch,
                                    codebooks_close, draws,  # noqa: F401
                                    gen_loss, grads_close, port_codec,
                                    train_export, train_variables,
                                    write_domains)
from test_torch_hcodec import L, L20, small10
from unified_audio_tpu.models.hcodec import codec as j_codec
from unified_audio_tpu.train import discriminators as j_disc
from unified_audio_tpu_torch.models.hcodec import codec as t_codec
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.train import discriminators as t_disc


def _port_step(cfg, variables, wav, feat, record, dtype, monkeypatch):
    """One ``forward(train=True)`` of the port in ``dtype`` with JAX's
    draws (``record``) handed over in order -> (loss, codec)."""
    rows = iter([x for k, x in record if k == "rows"])
    cuts = iter([x for k, x in record if k == "cut"])
    monkeypatch.setattr(t_quant, "sample_rows", lambda m, num, generator=None:
                        torch.as_tensor(np.array(next(rows))).long())
    monkeypatch.setattr(t_quant, "dropout_cutoff",
                        lambda nq, generator=None: int(next(cuts)))
    codec = port_codec(cfg, variables).to(dtype)
    w, f = (torch.as_tensor(a, dtype=dtype) for a in (wav, feat))
    recon, pred, commit = codec(w[..., None], f, train=True)
    loss = gen_loss(recon, pred, commit, w, f, cfg.sample_rate,
                    t_disc.multiscale_mel_loss)
    loss.backward()
    return loss.item(), codec


@pytest.mark.parametrize("cfg_fn,length", [(causal10, L), (causal20, L20)],
                         ids=["hcodec10", "hcodec20"])
def test_causal_training_forward(cfg_fn, length, draws,  # noqa: F811
                                 monkeypatch):
    """``HCodec(causal=True, trainable=True).forward(train=True)`` from the
    initial codebooks (k-means on this batch, JAX's draws): the
    generator's reconstruction loss within 1e-5 relative and the EMA
    buffers within 1e-5 (``codebooks_close``), in fp32 as JAX runs it.
    Every gradient within ``HCODEC_GRAD_TOL`` (1e-3) of its largest entry
    twice: the port's gradient function, run in fp64, against JAX's fp32
    gradients; and the port's fp32 gradients against that fp64 run. (Each
    side's fp32 rounding reaches several 1e-4 of the largest entry in the
    causal encoder's first convs: 3.65e-4 for JAX and 7.83e-4 for the port
    on the 1.0 case, so their fp32 gradients may part by more than 1e-3.)
    The causal codec's training state has the non-causal one's keys."""
    cfg = cfg_fn()
    plain = t_codec.HCodec(t_codec.HCodecConfig(**dataclasses.asdict(
        dataclasses.replace(cfg, causal=False))), trainable=True)
    variables = train_variables(cfg, length)
    wav, feat = batch(cfg, length, 13)
    jcodec = j_codec.HCodec(cfg)

    @jax.jit
    def step(params, codebook):
        def f(p):
            (recon, pred, commit), mut = jcodec.apply(
                {"params": p, "codebook": codebook}, wav[..., None], feat,
                train=True, mutable=["codebook"],
                rngs={"quant": jax.random.PRNGKey(3)})
            return gen_loss(recon, pred, commit, wav, feat, cfg.sample_rate,
                            j_disc.multiscale_mel_loss), mut["codebook"]
        return jax.value_and_grad(f, has_aux=True)(params)

    (loss, codebook), grads = step(variables["params"], variables["codebook"])
    jax.effects_barrier()
    kinds = [k for k, _ in draws]
    assert kinds.count("rows") == 2 * cfg.num_quantizers
    assert kinds.count("cut") == (2 if cfg.quantize_dropout else 0)
    want = train_export(cfg)({"params": jax.device_get(grads),
                              "codebook": jax.device_get(codebook)}, cfg)
    got32, codec32 = _port_step(cfg, variables, wav, feat, draws,
                                torch.float32, monkeypatch)
    assert codec32.config.causal
    assert codec32.state_dict().keys() == plain.state_dict().keys()
    assert abs(got32 - float(loss)) <= 1e-5 * abs(float(loss))
    buffers = {k for k, _ in codec32.named_buffers()}
    codebooks_close(codec32.state_dict(), {k: want[k] for k in buffers})
    got64, codec64 = _port_step(cfg, variables, wav, feat, draws,
                                torch.float64, monkeypatch)
    assert abs(got64 - float(loss)) <= 1e-5 * abs(float(loss))
    g64 = {k: p.grad.numpy() for k, p in codec64.named_parameters()}
    grads_close(g64, {k: v for k, v in want.items() if k not in buffers},
                HCODEC_GRAD_TOL)
    grads_close({k: p.grad.double().numpy()
                 for k, p in codec32.named_parameters()}, g64,
                HCODEC_GRAD_TOL)


# ---------------------------------------------------------------------------
# cli train-codec
# ---------------------------------------------------------------------------

def test_cli_train_codec_causal(tmp_path, monkeypatch):
    """``main(["train-codec", ..., "--device", "cpu"])`` with ``codec:
    {causal: true}`` trains a causal HCodec-1.0 (two steps, finite losses,
    a checkpoint of (g, v) weights); without a card and without
    ``--device cpu`` the same config exits with an error."""
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.data.audio_io import write_wav
    from unified_audio_tpu_torch.train import codec_trainer as t_trainer

    codec = {k: v for k, v in dataclasses.asdict(small10()).items()
             if k in ("latent_dim", "seanet_filters", "codebook_size",
                      "num_quantizers", "decoder_dim",
                      "decoder_intermediate_dim", "decoder_convnext_layers",
                      "semantic_encode_channels", "feat_dim")}
    config = {
        "model": "hcodec10", "seed": 2, "batch_size": 2,
        "segment_samples": L, "max_steps": 2, "log_every": 1,
        "save_every": 2, "ckpt_dir": str(tmp_path / "ckpt"),
        "codec": {**codec, "causal": True},
        "ssl": dict(hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=32, conv_dim=[16] * 7,
                    num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4),
        "train": {"perceptual_start_step": 10},
        "dataset": {"domain_scps": {d: [p] for d, p in write_domains(
            tmp_path, write_wav).items()}, "num_workers": 1,
            "samples_per_epoch": 4}}
    path = tmp_path / "codec.yaml"
    path.write_text(json.dumps(config))
    trainer = cli.main(["train-codec", "--config", str(path), "--device",
                        "cpu"])
    assert trainer.step == 2 and trainer.codec.config.causal
    enc = trainer.codec.encoder.model
    assert enc[0].causal and enc[14].causal
    records = [json.loads(l) for l in (tmp_path / "ckpt" / "metrics.jsonl")
               .read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records
               for k in t_trainer.METRICS)
    blob = torch.load(tmp_path / "ckpt" / "step_00000002.pt",
                      weights_only=True)
    assert any(k.endswith(".weight_v") for k in blob["gen"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["train-codec", "--config", str(path)])
