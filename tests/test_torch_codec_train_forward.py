"""HCodec-1.5's and FlexiCodec's training forwards of the port
(``unified_audio_tpu_torch``) against the JAX package on the CPU, at tiny
sizes: ``AdaptiveHCodec(trainable=True).forward(train=True)`` (the EMA
residual VQ with quantizer dropout over the aggregated groups, padding
groups included, k-means on the first batch, the SEANet encoder as (g,
v)) and ``FlexiCodec(trainable=True).forward`` (the DAC RVQ's commitment
and codebook losses, the distillation toward a teacher's features, in the
DualCodec and the aligned mode), with their gradients against
``jax.grad``; the distillation gradient leaves the decoder at zero; and
``teacher_features`` over HuBERT.

Weights come from the JAX package's seeded variables through the port's
``hcodec15_train_state_dict`` and ``flexicodec_train_state_dict``; JAX's
k-means rows and dropout cutoffs are handed to the port (the ``draws``
fixture). Tolerances: losses within 1e-5 relative, codes and group ids
exact, EMA buffers within 1e-5 (``codebooks_close``). Gradients: each
within 1e-3 of its largest entry, where fp32 rounding allows. HCodec-1.5
(as ``tests/test_torch_causal_train.py`` holds the causal codec): the
port's gradient function run in fp64 against JAX's fp32 gradients, and the
port's fp32 gradients against that fp64 run (each side's fp32 rounding
alone reaches several 1e-4). FlexiCodec: the port in fp64 against JAX in
fp64 (``jax.enable_x64``), since there each side's fp32 rounding reaches
2.2e-3 of the largest entry in the DAC encoder's Snake and conv gradients
(the two fp64 runs agree within 4.5e-12 in the DualCodec mode and 2.7e-5
in the aligned mode, whose JAX run keeps some fp32 constants).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adaptive import _inputs as adaptive_inputs
from test_torch_adaptive import _sims, margin, mid_threshold
from test_torch_adaptive import port_cfg as adaptive_port_cfg
from test_torch_adaptive import tiny_cfg as adaptive_cfg
from test_torch_codec_train import (HCODEC_GRAD_TOL, codebooks_close,
                                    draws, grads_close,  # noqa: F401
                                    init_codebooks)
from test_torch_common import random_variables, to_torch
from test_torch_flexicodec import T as FLEXI_T
from test_torch_flexicodec import _inputs as flexi_inputs
from test_torch_flexicodec import aligned_cfg
from test_torch_flexicodec import port_cfg as flexi_port_cfg
from test_torch_flexicodec import tiny_cfg as flexi_cfg
from test_torch_hcodec import tiny_hubert
from unified_audio_tpu.models.hcodec import adaptive as j_adaptive
from unified_audio_tpu.models.hcodec import flexicodec as j_flexi
from unified_audio_tpu.models.ssl import wav2vec2 as j_ssl
from unified_audio_tpu.train import discriminators as j_disc
from unified_audio_tpu_torch.models.hcodec import adaptive as t_adaptive
from unified_audio_tpu_torch.models.hcodec import flexicodec as t_flexi
from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.train import discriminators as t_disc
from unified_audio_tpu_torch.utils import convert as t_convert
from unified_audio_tpu_torch.utils.initialization import init_random_


def handing(record, monkeypatch):
    """Hand JAX's recorded k-means rows and dropout cutoffs to the port in
    order, from the first again (each port run replays them)."""
    rows = iter([x for k, x in record if k == "rows"])
    cuts = iter([x for k, x in record if k == "cut"])
    monkeypatch.setattr(t_quant, "sample_rows", lambda m, num, generator=None:
                        torch.as_tensor(np.array(next(rows))).long())
    monkeypatch.setattr(t_quant, "dropout_cutoff",
                        lambda nq, generator=None: int(next(cuts)))


def grads_twice(port_grads, want, buffers=()):
    """``port_grads(dtype)`` -> {name: gradient}: the fp64 run within
    ``HCODEC_GRAD_TOL`` of JAX's gradients ``want``, the fp32 run within it
    of the fp64 run."""
    g64 = port_grads(torch.float64)
    grads_close(g64, {k: v for k, v in want.items() if k not in buffers},
                HCODEC_GRAD_TOL)
    grads_close({k: v.astype(np.float64) for k, v in
                 port_grads(torch.float32).items()}, g64, HCODEC_GRAD_TOL)


def param_grads(module):
    """Each parameter's gradient (zeros where the loss did not reach it),
    fp64 numpy."""
    return {k: p.grad.double().numpy() if p.grad is not None
            else np.zeros(tuple(p.shape))
            for k, p in module.named_parameters()}


# ---------------------------------------------------------------------------
# HCodec-1.5
# ---------------------------------------------------------------------------

def adaptive_loss(recon, pred, commit, wav, feat, mel_loss):
    """The generator's reconstruction terms, as codec training sums them:
    15 x multi-scale mel + commitment + semantic L1."""
    target = wav[:, :recon.shape[-1], 0]
    return (15.0 * mel_loss(target, recon, 16000) + commit
            + abs(pred - feat).mean())


def test_adaptive_training_forward(draws, monkeypatch):  # noqa: F811
    """``AdaptiveHCodec.forward(train=True)`` on 2 clips from the initial
    codebooks at a fixed threshold: the loss within 1e-5 relative, the EMA
    buffers after the step within 1e-5, the draws JAX's (k-means once a
    layer, one cutoff a stream), the gradients of every parameter (the
    SEANet encoder's g and v, both aggregators, the bottleneck, the
    decoder) as the module docstring says."""
    cfg = adaptive_cfg(aggregator_layers=1)
    wav = np.concatenate([adaptive_inputs(20)[0], adaptive_inputs(21)[0]])
    feat = np.concatenate([adaptive_inputs(20)[1], adaptive_inputs(21)[1]])
    jm = j_adaptive.AdaptiveHCodec(cfg)
    variables = jax.device_get(random_variables(jm, wav, feat, seed=22))
    variables["codebook"] = init_codebooks(variables["codebook"])
    sem = jm.apply(variables, feat, method=lambda m, f: m.semantic_encoder(f))
    sims = _sims(sem)
    thr = mid_threshold(sims)

    @jax.jit
    def step(params, codebook):
        def f(p):
            (recon, pred, commit), mut = jm.apply(
                {"params": p, "codebook": codebook}, wav, feat, train=True,
                threshold=thr, mutable=["codebook"],
                rngs={"quant": jax.random.PRNGKey(4)})
            return adaptive_loss(recon, pred, commit, wav, feat,
                                 j_disc.multiscale_mel_loss), mut["codebook"]
        return jax.value_and_grad(f, has_aux=True)(params)

    (loss, codebook), grads = step(variables["params"], variables["codebook"])
    jax.effects_barrier()
    kinds = [k for k, _ in draws]
    assert kinds.count("rows") == 2 * cfg.base.num_quantizers
    assert kinds.count("cut") == 2
    want = t_convert.hcodec15_train_state_dict(
        {"params": jax.device_get(grads),
         "codebook": jax.device_get(codebook)}, cfg)
    sd = to_torch(t_convert.hcodec15_train_state_dict(variables, cfg))

    def run(dtype):
        handing(draws, monkeypatch)
        port = t_adaptive.AdaptiveHCodec(adaptive_port_cfg(cfg),
                                         trainable=True)
        port.load_state_dict(sd)
        port.to(dtype)
        w, f = (torch.as_tensor(a, dtype=dtype) for a in (wav, feat))
        recon, pred, commit = port(w, f, train=True, threshold=thr)
        got = adaptive_loss(recon, pred, commit, w, f,
                            t_disc.multiscale_mel_loss)
        got.backward()
        return got.item(), port

    got, port = run(torch.float32)
    msg = f"min |sim - thr| {margin(sims, thr):.3e}"
    assert abs(got - float(loss)) <= 1e-5 * abs(float(loss)), msg
    assert any(k.endswith("weight_g") for k, _ in port.named_parameters())
    buffers = {k for k, _ in port.named_buffers()}
    codebooks_close(port.state_dict(), {k: want[k] for k in buffers})
    grads_twice(lambda dtype: param_grads(run(dtype)[1]), want, buffers)


def test_adaptive_padding_groups_enter_the_codebooks(monkeypatch):
    """The padding groups' zero rows take part in the training VQ, as in
    JAX: with G = T groups a clip, k-means and the EMA counts see all B x
    T rows, so after one step each layer's cluster sizes sum to B x T. (A
    threshold of -1 leaves the length cap of 4 frames to form the
    groups: 3 groups and 9 padding groups a clip.)"""
    cfg = adaptive_cfg(aggregator_layers=1)
    port = t_adaptive.AdaptiveHCodec(adaptive_port_cfg(cfg), trainable=True)
    init_random_(port, torch.Generator().manual_seed(0))
    for rvq in (port.quantizer, port.semantic_quantizer):
        for layer in rvq.layers:
            layer._codebook.embed.zero_()
            layer.kmeans_iters = 2
    wav, feat = adaptive_inputs(23)
    with torch.no_grad():
        port(torch.as_tensor(wav), torch.as_tensor(feat), train=True,
             threshold=-1.0, generator=torch.Generator().manual_seed(1))
        counts = port.align(torch.as_tensor(wav), torch.as_tensor(feat),
                            -1.0)[3]
    assert (counts == 0).any(), "no padding group"
    t = feat.shape[1] // 2
    for rvq in (port.quantizer, port.semantic_quantizer):
        for layer in rvq.layers:
            assert abs(layer._codebook.cluster_size.sum().item() - t) \
                <= 1e-4 * t


# ---------------------------------------------------------------------------
# FlexiCodec
# ---------------------------------------------------------------------------

def flexi_loss(out, wav):
    """Reconstruction L1 + the RVQ losses + the distillation."""
    recon = out["recons"]
    return (abs(recon - wav[:, :recon.shape[-1]]).mean() + out["commit_loss"]
            + out["distill_loss"])


@pytest.mark.parametrize("aligned", [False, True], ids=["dual", "aligned"])
def test_flexicodec_training_forward(aligned):
    """``FlexiCodec.forward`` with a teacher's features (teacher width 24,
    the semantic stream 16: the distillation takes the first 16): every
    output's keys; codes, FSQ indices and group ids exact; recons,
    commit_loss and distill_loss within 1e-5 relative (recons within 1e-4
    of its peak); the gradients of every parameter (the weight-normed DAC
    and adapter convs as (g, v), the codebooks, the FSQ projections, in
    the aligned mode the aggregators and the bottleneck) as the module
    docstring says (fp64 on both sides)."""
    cfg = (aligned_cfg if aligned else flexi_cfg)()
    wav, sem = flexi_inputs(24)
    teacher = np.random.default_rng(25).standard_normal(
        (1, 2 * FLEXI_T, 24)).astype(np.float32)
    jm = j_flexi.FlexiCodec(cfg)
    variables = jax.device_get(random_variables(
        jm, wav, sem, seed=26, out_gain=0.05))
    kw = {}
    if aligned:
        sims = _sims(np.asarray(sem).reshape(1, FLEXI_T, 2, -1).mean(2))
        kw = dict(threshold=mid_threshold(sims))

    def f(p):
        out = jm.apply({"params": p}, wav, sem, teacher_feats=teacher,
                       train=True, **kw)
        return flexi_loss(out, wav), out

    loss, out = jax.jit(f)(variables["params"])
    w64, s64, t64 = (a.astype(np.float64) for a in (wav, sem, teacher))
    with jax.enable_x64(True):
        grads = jax.jit(jax.grad(lambda p: flexi_loss(jm.apply(
            {"params": p}, w64, s64, teacher_feats=t64, train=True, **kw),
            w64)))(jax.tree_util.tree_map(lambda x: np.asarray(
                x, np.float64), variables["params"]))
        want = t_convert.flexicodec_train_state_dict(
            {"params": jax.device_get(grads)}, cfg)
    sd = to_torch(t_convert.flexicodec_train_state_dict(variables, cfg))

    def run(dtype):
        port = t_flexi.FlexiCodec(flexi_port_cfg(cfg), trainable=True)
        port.load_state_dict(sd)
        port.to(dtype)
        got = port(*(torch.as_tensor(a, dtype=dtype)
                     for a in (wav, sem, teacher)), train=True, **kw)
        total = flexi_loss(got, torch.as_tensor(wav, dtype=dtype))
        total.backward()
        return total.item(), got, port

    got_loss, got, port = run(torch.float32)
    assert set(got) == set(out)
    for k in ("acoustic_codes", "semantic_codes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(out[k]))
    if aligned:
        np.testing.assert_array_equal(got["group_ids"].numpy(),
                                      np.asarray(out["group_ids"]))
        assert 1 < int(got["group_ids"].max()) + 1 < FLEXI_T
    else:
        assert got["group_ids"] is None and out["group_ids"] is None
    for k in ("commit_loss", "distill_loss"):
        w = float(out[k])
        assert abs(got[k].item() - w) <= 1e-5 * abs(w), (k, got[k], w)
    assert abs(got_loss - float(loss)) <= 1e-5 * abs(float(loss))
    r = np.asarray(out["recons"])
    assert np.abs(got["recons"].detach().numpy() - r).max() <= \
        1e-4 * np.abs(r).max()
    assert any(k.endswith("weight_g") and "decoder.model.1.block.1" in k
               for k, _ in port.named_parameters())  # a transposed conv
    grads_close(param_grads(run(torch.float64)[2]), want, HCODEC_GRAD_TOL)


def test_distillation_gradient_leaves_the_decoder():
    """The distillation loss alone reaches the semantic branch (the adapter
    encoder) and not the DAC decoder: its gradient there is zero, in the
    port as in JAX."""
    cfg = flexi_cfg()
    wav, sem = flexi_inputs(27)
    teacher = np.random.default_rng(28).standard_normal(
        (1, 2 * FLEXI_T, cfg.convnext_dim)).astype(np.float32)
    jm = j_flexi.FlexiCodec(cfg)
    variables = jax.device_get(random_variables(
        jm, wav, sem, seed=29, out_gain=0.05))
    grads = jax.jit(jax.grad(lambda p: jm.apply(
        {"params": p}, wav, sem, teacher_feats=teacher)["distill_loss"]))(
            variables["params"])
    j_dec = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree_util.tree_leaves(grads["decoder"]))
    port = t_flexi.FlexiCodec(flexi_port_cfg(cfg), trainable=True)
    port.load_state_dict(to_torch(t_convert.flexicodec_train_state_dict(
        variables, cfg)))
    port(torch.as_tensor(wav), torch.as_tensor(sem),
         torch.as_tensor(teacher))["distill_loss"].backward()
    g = param_grads(port)
    dec = max(np.abs(v).max() for k, v in g.items()
              if k.startswith("dac.decoder."))
    enc = max(np.abs(v).max() for k, v in g.items()
              if k.startswith("convnext_encoder."))
    assert j_dec == 0.0 and dec == 0.0 and enc > 0.0


def test_teacher_features():
    """``teacher_features`` over a tiny HuBERT (9 frames of 3200 samples):
    JAX's within 1e-4, no gradient."""
    ssl_cfg = tiny_hubert(16)
    wav = np.random.default_rng(30).standard_normal((1, 3200)).astype(
        np.float32)
    jm = j_ssl.Wav2Vec2Model(ssl_cfg)
    ssl_vars = jax.device_get(random_variables(jm, wav, seed=31))
    want = j_flexi.teacher_features(jm, ssl_vars, jnp.asarray(wav))
    ssl = t_ssl.Wav2Vec2Model(t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg)))
    ssl.load_state_dict(to_torch(t_convert.hubert_state_dict(ssl_vars,
                                                             ssl_cfg)))
    x = torch.as_tensor(wav).requires_grad_(True)
    got = t_flexi.teacher_features(ssl.eval(), x)
    assert not got.requires_grad and got.shape == want.shape == (1, 9, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
