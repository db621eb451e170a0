"""HCodec GAN training of the port (``unified_audio_tpu_torch``) against the
JAX package on the CPU, at tiny sizes: k-means, the EMA VQ layer, quantizer
dropout, ``SemanticDecoder``, ``HCodec.forward(train=True)`` for 1.0 and
2.0, the discriminators and the GAN losses, the multi-scale mel loss,
three ``CodecGANTrainer`` steps, and ``cli train-codec``.

The port's random draws (k-means' initial rows, the dropout cutoffs) are
handed in from the JAX package's: the tests record them with ordered
``jax.debug.callback``s (in JAX's ``kmeans`` and its scalar
``jax.random.randint``) and the port's ``sample_rows`` and
``dropout_cutoff`` give them back in order. Tolerances are stated per
test.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import random_variables, to_torch
from unified_audio_tpu.models.hcodec import codec as j_codec
from unified_audio_tpu.models.hcodec import semantic as j_semantic
from unified_audio_tpu.ops import dsp as j_dsp
from unified_audio_tpu.ops import quant as j_quant
from unified_audio_tpu.train import codec_trainer as j_trainer
from unified_audio_tpu.train import discriminators as j_disc
from unified_audio_tpu_torch.models.hcodec import codec as t_codec
from unified_audio_tpu_torch.models.hcodec import semantic as t_semantic
from unified_audio_tpu_torch.ops import dsp as t_dsp
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.train import codec_trainer as t_trainer
from unified_audio_tpu_torch.train import discriminators as t_disc
from unified_audio_tpu_torch.utils import convert as t_convert

L = 640 * 8  # 8 frames of the 25 Hz codec
L20 = 3840 * 2  # 2 frames of the 12.5 Hz codec at 48 kHz


def small10():
    return j_codec.hcodec10_config(
        latent_dim=64, seanet_filters=4, codebook_size=32, num_quantizers=2,
        decoder_dim=64, decoder_intermediate_dim=128,
        decoder_convnext_layers=2, semantic_encode_channels=64, feat_dim=32)


def small20():
    return j_codec.hcodec20_config(
        latent_dim=64, codebook_size=32, num_quantizers=2,
        decoder_dim=64, decoder_intermediate_dim=128,
        decoder_convnext_layers=2, encoder_dim=64,
        encoder_intermediate_dim=128, encoder_convnext_layers=2,
        semantic_encode_channels=64, feat_dim=32)


def port_cfg(cfg):
    return t_codec.HCodecConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# The JAX package's draws, handed to the port
# ---------------------------------------------------------------------------

@pytest.fixture
def draws(monkeypatch):
    """Records JAX's k-means rows and dropout cutoffs, in program order,
    and hands them to the port's ``sample_rows`` / ``dropout_cutoff`` in
    the same order. Returns the record: [("rows", idx) | ("cut", int)]."""
    record, given = [], {"rows": 0, "cut": 0}
    kmeans, randint = j_quant.kmeans, jax.random.randint

    def rec(kind):
        def put(x):
            record.append((kind, np.asarray(x)))
        return put

    def recording_kmeans(key, samples, num_clusters, num_iters=10):
        m = samples.shape[0]
        idx = (jax.random.permutation(key, m)[:num_clusters]
               if m >= num_clusters
               else randint(key, (num_clusters,), 0, m))
        jax.debug.callback(rec("rows"), idx, ordered=True)
        return kmeans(key, samples, num_clusters, num_iters)

    def recording_randint(key, shape, minval, maxval, *a, **kw):
        out = randint(key, shape, minval, maxval, *a, **kw)
        if tuple(shape) == ():
            jax.debug.callback(rec("cut"), out, ordered=True)
        return out

    def handed(kind):
        jax.effects_barrier()
        got = [x for k, x in record if k == kind]
        i = given[kind]
        given[kind] += 1
        assert i < len(got), f"the port drew more {kind} than JAX"
        return got[i]

    monkeypatch.setattr(j_quant, "kmeans", recording_kmeans)
    monkeypatch.setattr(jax.random, "randint", recording_randint)
    monkeypatch.setattr(t_quant, "sample_rows", lambda m, num, generator=None:
                        torch.as_tensor(np.array(handed("rows"))).long())
    monkeypatch.setattr(t_quant, "dropout_cutoff",
                        lambda nq, generator=None: int(handed("cut")))
    return record


def init_codebooks(codebook):
    """The JAX package's initial codebook state (before k-means)."""
    return jax.tree_util.tree_map(np.zeros_like, codebook)


def close(got, want, atol, rtol=0.0, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def grads_close(port_grads, jax_grads, tol=1e-4):
    """Each gradient within ``tol`` of its largest entry."""
    assert set(port_grads) == set(jax_grads)
    for k, want in jax_grads.items():
        want = np.asarray(want)
        err = np.abs(port_grads[k] - want).max()
        assert err <= tol * np.abs(want).max(), (k, err, np.abs(want).max())


# ---------------------------------------------------------------------------
# k-means and the EMA VQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [20, 48])
def test_kmeans_from_the_same_rows(m):
    """Lloyd's k-means from JAX's initial rows at N = 32: M = 20 draws rows
    with replacement (duplicate means, empty bins that keep their mean),
    M = 48 a permutation. Means within 1e-5, bins exact."""
    x = np.random.default_rng(m).standard_normal((m, 16)).astype(np.float32)
    key = jax.random.PRNGKey(m)
    idx = (jax.random.permutation(key, m)[:32] if m >= 32
           else jax.random.randint(key, (32,), 0, m))
    want_means, want_bins = j_quant.kmeans(key, jnp.asarray(x), 32, 10)
    drawn = []

    def rows(n, num, generator=None):
        drawn.append((n, num))
        return torch.as_tensor(np.array(idx)).long()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_quant, "sample_rows", rows)
        means, bins = t_quant.kmeans(torch.as_tensor(x), 32, 10)
    assert drawn == [(m, 32)]
    if m < 32:
        assert len(set(np.asarray(idx).tolist())) < 32  # duplicates
        assert (np.asarray(want_bins) == 0).any()  # empty bins
    close(means, want_means, atol=1e-5)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(want_bins))


def test_sample_rows_draws():
    """A permutation's first rows when M >= N, draws with replacement in
    [0, M) otherwise; the cutoff in [0, nq)."""
    g = torch.Generator().manual_seed(0)
    a = t_quant.sample_rows(50, 32, g)
    assert a.shape == (32,) and len(set(a.tolist())) == 32 and a.max() < 50
    b = t_quant.sample_rows(20, 32, g)
    assert b.shape == (32,) and b.min() >= 0 and b.max() < 20
    assert {t_quant.dropout_cutoff(4, g) for _ in range(64)} == {0, 1, 2, 3}


def _jax_vq_steps(layer, x, steps, grad_of=None):
    variables = layer.init({"params": jax.random.PRNGKey(0),
                            "quant": jax.random.PRNGKey(1)}, x[0],
                           train=False)
    cb = init_codebooks(variables["codebook"])

    @jax.jit
    def step(cb, x, key):
        def f(x):
            (q, idx, loss), mut = layer.apply(
                {"codebook": cb}, x, train=True, mutable=["codebook"],
                rngs={"quant": key})
            return jnp.sum(q * grad_of) + loss, (q, idx, loss, mut)
        return jax.value_and_grad(f, has_aux=True)(x)

    out = []
    for i in range(steps):
        (_, (q, idx, loss, mut)), g = step(cb, x[i], jax.random.PRNGKey(7 + i))
        cb = mut["codebook"]
        out.append((q, idx, loss, g, jax.device_get(cb)))
    return out


def test_vector_quantization_training_forward(draws):
    """Two training batches through one EMA VQ layer (N = 32, D = 16, 15
    rows, so k-means starts from duplicates): codes exact; embed,
    embed_avg and cluster_size within 1e-5; the commitment loss within
    1e-6; the straight-through gradient within 1e-5; ``initted`` 1."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    up = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = _jax_vq_steps(j_quant.VectorQuantization(16, 32), x, 2, up)
    layer = t_quant.VectorQuantization(16, 32, ema=True)
    for i, (q, idx, loss, g, cb) in enumerate(want):
        xt = torch.as_tensor(x[i]).requires_grad_(True)
        got_q, got_idx, got_loss = layer(xt, train=True)
        ((got_q * torch.as_tensor(up)).sum() + got_loss).backward()
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        close(got_q, q, atol=1e-5)
        close(got_loss, loss, atol=1e-6)
        close(xt.grad, g, atol=1e-5)
        c = layer._codebook
        close(c.embed[0], cb["embed"], atol=1e-5)
        close(c.embed_avg[0], cb["embed_avg"], atol=1e-5)
        close(c.cluster_size[0], cb["cluster_size"], atol=1e-5)
        assert c.initted.item() == 1.0 and c.is_initted()
    assert [k for k, _ in draws] == ["rows"]  # k-means once, first batch


@pytest.mark.parametrize("cutoff", [0, 1, 2])
def test_residual_vq_dropout_cutoff(cutoff):
    """Quantizer dropout with a given cutoff, against JAX with the same
    cutoff: layers past it give codes -1, zeros and a zero loss, yet
    search and update their codebooks; the sum, codes, losses and the
    input gradient equal JAX's (codes exact, floats within 1e-5)."""
    rng = np.random.default_rng(cutoff)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    rows = [rng.integers(0, 12, 32) for _ in range(3)]
    rvq = j_quant.ResidualVQ(16, 32, 3, quantize_dropout=True,
                             kmeans_iters=5)
    randint = jax.random.randint
    cb = init_codebooks(rvq.init({"params": jax.random.PRNGKey(0),
                                  "quant": jax.random.PRNGKey(1)}, x,
                                 train=False)["codebook"])
    it, in_kmeans = iter(rows), []
    kmeans, sample_vectors = j_quant.kmeans, j_quant.sample_vectors

    def given_kmeans(*args):
        in_kmeans.append(True)
        try:
            return kmeans(*args)
        finally:
            in_kmeans.pop()

    def given_rows(key, s, num):  # k-means' rows; others drawn as before
        if in_kmeans:
            return s[jnp.asarray(next(it))]
        return sample_vectors(key, s, num)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_quant, "kmeans", given_kmeans)
        mp.setattr(j_quant, "sample_vectors", given_rows)
        mp.setattr(jax.random, "randint",
                   lambda key, shape, *a, **k: jnp.asarray(cutoff, jnp.int32)
                   if tuple(shape) == () else randint(key, shape, *a, **k))

        def f(x):
            (q, codes, losses), mut = rvq.apply(
                {"codebook": cb}, x, train=True, mutable=["codebook"],
                rngs={"quant": jax.random.PRNGKey(2)})
            return jnp.sum(q ** 2) + losses.sum(), (q, codes, losses, mut)

        (_, (q, codes, losses, mut)), g = jax.value_and_grad(
            f, has_aux=True)(jnp.asarray(x))
    port = t_quant.ResidualVQ(16, 32, 3, ema=True, quantize_dropout=True)
    for layer in port.layers:
        layer.kmeans_iters = 5
    it = iter(rows)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_quant, "sample_rows", lambda m, num, generator=None:
                   torch.as_tensor(next(it)))
        mp.setattr(t_quant, "dropout_cutoff", lambda nq, generator=None:
                   cutoff)
        xt = torch.as_tensor(x).requires_grad_(True)
        got_q, got_codes, got_losses = port(xt, train=True)
        ((got_q ** 2).sum() + got_losses.sum()).backward()
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(codes))
    assert (got_codes[..., cutoff + 1:] == -1).all()
    assert (got_codes[..., :cutoff + 1] >= 0).all()
    assert (got_losses[cutoff + 1:] == 0).all()
    close(got_q, q, atol=1e-5)
    close(got_losses, losses, atol=1e-5)
    close(xt.grad, g, atol=1e-5)
    for i, layer in enumerate(port.layers):  # every layer updated
        assert layer._codebook.initted.item() == 1.0
        close(layer.embed, mut["codebook"][f"layers_{i}"]["embed"],
              atol=1e-5)


# ---------------------------------------------------------------------------
# SemanticDecoder, discriminators, losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strides,ratios", [((2, 1), (1, 1)),
                                            ((2, 1, 2), (1, 1, 1))])
def test_semantic_decoder(strides, ratios):
    """``SemanticDecoder`` (1.0's strides and 2.0's) within 1e-4 of JAX's
    on weights carried over in the reference layout."""
    z = np.random.default_rng(5).standard_normal((2, 6, 16)).astype(
        np.float32)
    jdec = j_semantic.SemanticDecoder(16, 12, 24, ratios, strides)
    variables = random_variables(jdec, z, seed=6)
    want = jdec.apply(variables, z)
    sd = {}
    t_convert._semantic_branch(variables["params"], "semantic_decoder",
                               strides, sd)
    dec = t_semantic.SemanticDecoder(16, 12, 24, ratios, strides)
    dec.load_state_dict({k[len("semantic_decoder."):]: v
                         for k, v in to_torch(sd).items()})
    with torch.no_grad():
        got = dec(torch.as_tensor(z))
    assert got.shape == want.shape == (2, 6 * int(np.prod(strides)), 12)
    close(got, want, atol=1e-4, rtol=1e-4)


TINY_DISC = dict(periods=(2, 3), stft_resolutions=((256, 64), (128, 32)))


@pytest.fixture(scope="module")
def discs():
    """A tiny JAX ``CodecDiscriminator`` with random weights and the port's
    with the same (``codec_discriminator_state_dict``)."""
    jd = j_disc.CodecDiscriminator(**TINY_DISC)
    params = random_variables(jd, np.zeros((1, 2000, 1), np.float32),
                              seed=8)
    td = t_disc.CodecDiscriminator(**TINY_DISC)
    td.load_state_dict(to_torch(t_convert.codec_discriminator_state_dict(
        params)))
    return jd, params, td


def test_discriminators(discs):
    """Each discriminator's scores and feature maps (NHWC in JAX, NCHW in
    the port; a length that is no multiple of the period, so the reflect
    pad runs; "SAME" padding at stride 2) within 1e-4."""
    jd, params, td = discs
    x = 0.3 * np.random.default_rng(9).standard_normal((2, 2001)).astype(
        np.float32)
    scores, feats = jd.apply(params, x[..., None])
    with torch.no_grad():
        got_scores, got_feats = td(torch.as_tensor(x))
    assert len(got_scores) == len(scores) == 4
    for s, w in zip(got_scores, scores):
        close(s, w, atol=1e-4, rtol=1e-4)
    for fs, ws in zip(got_feats, feats):
        assert len(fs) == len(ws)
        for f, w in zip(fs, ws):
            close(f.permute(0, 2, 3, 1), w, atol=1e-4, rtol=1e-4)


def test_gan_losses_and_gradients(discs):
    """The four losses on two inputs (discriminator loss, generator
    adversarial loss, feature matching with the real side detached, the
    multi-scale mel loss) within 1e-5 relative, and the gradients of the
    discriminator loss (every weight) and of the generator's terms (the
    fake wav) each within 1e-4 of its largest entry."""
    jd, params, td = discs
    rng = np.random.default_rng(10)
    real = 0.3 * rng.standard_normal((2, 2400)).astype(np.float32)
    fake = 0.3 * rng.standard_normal((2, 2400)).astype(np.float32)

    def j_losses(p, real, fake):
        rs, rf = jd.apply(p, real[..., None])
        fs, ff = jd.apply(p, fake[..., None])
        return (j_disc.discriminator_loss(rs, fs),
                j_disc.generator_adversarial_loss(fs),
                j_disc.feature_matching_loss(rf, ff),
                j_disc.multiscale_mel_loss(real, fake))

    want, d_grads = jax.jit(lambda p: (
        j_losses(p, real, fake),
        jax.grad(lambda q: j_losses(q, real, fake)[0])(p)))(params)
    g_grad = jax.jit(jax.grad(
        lambda f: sum(j_losses(params, real, f)[1:])))(fake)

    fk = torch.as_tensor(fake).requires_grad_(True)
    rt = torch.as_tensor(real)
    rs, rf = td(rt)
    fs, ff = td(fk)
    got = (t_disc.discriminator_loss(rs, fs),
           t_disc.generator_adversarial_loss(fs),
           t_disc.feature_matching_loss(rf, ff),
           t_disc.multiscale_mel_loss(rt, fk))
    for g, w in zip(got, want):
        close(g, w, atol=0.0, rtol=1e-5)
    names, weights = zip(*td.named_parameters())
    d_got = torch.autograd.grad(got[0], weights, retain_graph=True)
    grads_close({k: g.numpy() for k, g in zip(names, d_got)},
                t_convert.codec_discriminator_state_dict(d_grads))
    (g_got,) = torch.autograd.grad(sum(got[1:]), fk)
    grads_close({"fake": g_got.numpy()}, {"fake": g_grad})


def test_multiscale_mel_loss_scales():
    """Each of the seven scales (n_fft 32 to 2048, hop n_fft / 4, min(80,
    n_fft / 2) slaney mels to sr / 2): the filter bank equal to JAX's (at
    n_fft 32 and 64 some triangles are empty), the mel spectrogram within
    1e-5 relative, the loss and its gradient as in
    ``test_gan_losses_and_gradients``."""
    rng = np.random.default_rng(11)
    real = 0.3 * rng.standard_normal((2, 4800)).astype(np.float32)
    fake = 0.3 * rng.standard_normal((2, 4800)).astype(np.float32)
    for n_fft in (32, 64, 128, 256, 512, 1024, 2048):
        mels = min(80, n_fft // 2)
        fb = t_dsp.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, mels, 16000,
                                   norm="slaney", mel_scale="slaney")
        want_fb = np.asarray(j_dsp.melscale_fbanks(
            n_fft // 2 + 1, 0.0, 8000.0, mels, 16000, norm="slaney",
            mel_scale="slaney"))
        np.testing.assert_array_equal(fb, want_fb)
        if n_fft <= 64:
            assert (fb.sum(0) == 0).any()  # empty triangles
        want = jax.jit(lambda x: j_dsp.mel_spectrogram(
            x, 16000, n_fft, n_fft, n_fft // 4, 0.0, 8000.0, mels))(real)
        got = t_dsp.mel_spectrogram(torch.as_tensor(real), 16000, n_fft,
                                    n_fft, n_fft // 4, 0.0, 8000.0, mels)
        close(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=1e-5)
        loss, g = jax.jit(jax.value_and_grad(
            lambda f: j_disc.multiscale_mel_loss(real, f, n_ffts=(n_fft,))))(
                fake)
        fk = torch.as_tensor(fake).requires_grad_(True)
        got_loss = t_disc.multiscale_mel_loss(torch.as_tensor(real), fk,
                                              n_ffts=(n_fft,))
        got_loss.backward()
        close(got_loss, loss, atol=0.0, rtol=1e-5)
        grads_close({"fake": fk.grad.numpy()}, {"fake": g})


# ---------------------------------------------------------------------------
# HCodec's training forward
# ---------------------------------------------------------------------------

# The codec's gradients carry fp32 rounding of a few 1e-4 of their largest
# entry: on the 1.0 case below, held against the same step run in fp64 by
# the port, JAX's fp32 gradients are off by up to 3.4e-4 (the SEANet
# encoder's first convs' biases and gains) and the port's by 1.5e-4.
HCODEC_GRAD_TOL = 1e-3


def codebooks_close(state, want, tol=1e-5):
    """The EMA buffers of ``state`` (the port's) against ``want`` (JAX's,
    converted): ``cluster_size`` and ``embed_avg`` within ``tol``; a
    codebook row within ``tol`` over its smoothed cluster size (at least
    1), since the row is ``embed_avg`` divided by it (~1e-5 for a bin
    k-means left empty, so the row is ~1e5 times its mean)."""
    keys = [k for k in want if "._codebook." in k]
    assert keys and set(keys) <= set(state)
    for k in keys:
        got, w = state[k].numpy(), np.asarray(want[k])
        if k.endswith(".embed"):
            size = np.asarray(want[k[:-len("embed")] + "cluster_size"])
            n = size.sum(-1, keepdims=True)
            smoothed = (size + 1e-5) / (n + size.shape[-1] * 1e-5) * n
            limit = tol * np.maximum(1.0, 1.0 / smoothed)[..., None]
        else:
            limit = tol
        assert (np.abs(got - w) <= limit).all(), (k, np.abs(got - w).max())


def train_variables(cfg, length, seed=12):
    """Seeded JAX variables of ``cfg`` with the initial codebook state."""
    frames = length // (320 if cfg.version == "1.0" else 960)
    variables = jax.device_get(random_variables(
        j_codec.HCodec(cfg), np.zeros((1, length, 1), np.float32),
        np.zeros((1, frames, cfg.feat_dim), np.float32), seed=seed))
    variables["codebook"] = init_codebooks(variables["codebook"])
    return variables


def train_export(cfg):
    return (t_convert.hcodec10_train_state_dict if cfg.version == "1.0"
            else t_convert.hcodec20_train_state_dict)


def port_codec(cfg, variables):
    codec = t_codec.HCodec(port_cfg(cfg), trainable=True)
    codec.load_state_dict(to_torch(train_export(cfg)(variables, cfg)))
    return codec


def batch(cfg, length, seed, b=2):
    rng = np.random.default_rng(seed)
    frames = length // (320 if cfg.version == "1.0" else 960)
    t = np.arange(length) / cfg.sample_rate
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)[None]
           + 0.1 * rng.standard_normal((b, length))).astype(np.float32)
    feat = rng.standard_normal((b, frames, cfg.feat_dim)).astype(np.float32)
    return wav, feat


def gen_loss(recon, pred_feat, commit, wav, feat, sr, mel_loss):
    target = wav[:, :recon.shape[-1]]
    return (15.0 * mel_loss(target, recon, sr)
            + commit + abs(pred_feat - feat).mean())


@pytest.mark.parametrize("cfg_fn,length", [(small10, L), (small20, L20)],
                         ids=["hcodec10", "hcodec20"])
def test_hcodec_training_forward(cfg_fn, length, draws):
    """``HCodec.forward(train=True)`` from the initial codebooks (k-means on
    this batch, at M = 16 rows for N = 32 codes; 1.0 with quantizer
    dropout): the generator's reconstruction loss (15 x mel + commit +
    semantic L1) within 1e-5 relative, every parameter's gradient (the
    SEANet encoder's g and v included) within ``HCODEC_GRAD_TOL`` of its
    largest entry, the EMA buffers after the step within 1e-5
    (``codebooks_close``), and the port drew what JAX drew."""
    cfg = cfg_fn()
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
    codec = port_codec(cfg, variables)
    if cfg.version == "1.0":
        assert any(k.endswith("weight_g") for k, _ in
                   codec.named_parameters())
    recon, pred, commit = codec(torch.as_tensor(wav)[..., None],
                                torch.as_tensor(feat), train=True)
    got = gen_loss(recon, pred, commit, torch.as_tensor(wav),
                   torch.as_tensor(feat), cfg.sample_rate,
                   t_disc.multiscale_mel_loss)
    got.backward()
    close(got, loss, atol=0.0, rtol=1e-5)
    want = train_export(cfg)({"params": jax.device_get(grads),
                              "codebook": jax.device_get(codebook)}, cfg)
    state = codec.state_dict()
    buffers = {k for k, _ in codec.named_buffers()}
    grads_close({k: p.grad.numpy() for k, p in codec.named_parameters()},
                {k: v for k, v in want.items() if k not in buffers},
                HCODEC_GRAD_TOL)
    codebooks_close(state, {k: want[k] for k in buffers})
    kinds = [k for k, _ in draws]
    assert kinds.count("rows") == 2 * cfg.num_quantizers
    assert kinds.count("cut") == (2 if cfg.quantize_dropout else 0)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def test_codec_gan_trainer_three_steps(draws):
    """Three ``CodecGANTrainer`` steps of the tiny 1.0 codec against the
    full discriminator ensemble, from JAX's own initial state (converted),
    with ``perceptual_start_step=1``: step 0 reconstructs, steps 1-2 add
    the adversarial terms and update the discriminator. Each step's
    metrics within 1e-4 relative (the adversarial ones 0 at step 0); after
    the steps the EMA buffers within 1e-5 (``codebooks_close``) and the
    generator's and discriminator's parameters within 1e-5, all but at
    most one entry in 1e4: AdamW divides each update by the gradient's own
    size, so an entry whose gradient is at the level of fp32 rounding (the
    gradients agree within ``HCODEC_GRAD_TOL`` of their largest entry)
    can move by up to the rate each step in either run. Such an entry
    must still lie within 2 x lr x 3 steps, the most three updates can
    part two runs by (388 of 42,264,730 entries exceed 1e-5 here)."""
    cfg = small10()
    wav, feat = batch(cfg, L, 14)
    tcfg = j_trainer.CodecTrainConfig(perceptual_start_step=1)
    jt = j_trainer.CodecGANTrainer(cfg, tcfg, rng=jax.random.PRNGKey(0),
                                   example_batch=(wav, feat))
    codec = port_codec(cfg, jax.device_get(jt.gen_vars))
    disc = t_disc.CodecDiscriminator()
    disc.load_state_dict(to_torch(t_convert.codec_discriminator_state_dict(
        jax.device_get(jt.disc_params))))
    tt = t_trainer.CodecGANTrainer(
        codec, t_trainer.CodecTrainConfig(**dataclasses.asdict(tcfg)), disc)
    for i in range(3):
        want = jt.train_step(jnp.asarray(wav), jnp.asarray(feat),
                             jax.random.PRNGKey(20 + i))
        got = tt.train_step(torch.as_tensor(wav), torch.as_tensor(feat))
        assert set(got) == set(want)
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-4 * abs(w), (i, k, got[k], w)
        assert (got["adv"] == 0.0) == (i == 0)
    gen = train_export(cfg)(jax.device_get(jt.gen_vars), cfg)
    codebooks_close(codec.state_dict(), gen)
    dsd = t_convert.codec_discriminator_state_dict(
        jax.device_get(jt.disc_params))
    beyond, total = 0, 0
    for got, want in ((codec.state_dict(), gen), (disc.state_dict(), dsd)):
        assert set(got) == set(want)
        for k, w in want.items():
            if "._codebook." in k:
                continue
            err = np.abs(got[k].numpy() - np.asarray(w))
            assert err.max() <= 2 * tcfg.lr * 3, (k, err.max())
            beyond += int((err > 1e-5).sum())
            total += err.size
    assert beyond <= 1e-4 * total, (beyond, total)


# ---------------------------------------------------------------------------
# cli train-codec
# ---------------------------------------------------------------------------

def jax_variables_from(sd, template, export, cfg):
    """The JAX variables whose ``export(variables, cfg)`` is ``sd``, for an
    export that only moves entries (transposes, reshapes, splits): every
    entry of ``template`` is tagged with its own index, exported, and
    ``sd``'s values put back where the tags say."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    tags, start = [], 0
    for leaf in leaves:
        n = int(np.size(leaf))
        tags.append(np.arange(start, start + n, dtype=np.float64).reshape(
            np.shape(leaf)))
        start += n
    flat = np.full(start, np.nan, np.float32)
    for k, tag in export(jax.tree_util.tree_unflatten(treedef, tags),
                         cfg).items():
        flat[np.asarray(tag).astype(np.int64).ravel()] = np.asarray(
            sd[k], np.float32).ravel()
    assert not np.isnan(flat).any(), "an entry the export does not cover"
    out, start = [], 0
    for leaf in leaves:
        n = int(np.size(leaf))
        out.append(flat[start:start + n].reshape(np.shape(leaf)))
        start += n
    return jax.tree_util.tree_unflatten(treedef, out)


def write_domains(tmp_path, write_wav):
    """Two domains of three 0.5-s wavs each: tones ("speech") and noise
    ("audio")."""
    rng = np.random.default_rng(15)
    scps = {}
    for domain in ("speech", "audio"):
        lines = []
        for i in range(3):
            t = np.arange(8000) / 16000
            x = (0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                 if domain == "speech" else 0.2 * rng.standard_normal(8000))
            path = tmp_path / f"{domain}{i}.wav"
            write_wav(path, x.astype(np.float32), 16000)
            lines.append(f"{domain}{i} s{i} {path}")
        scps[domain] = str(tmp_path / f"{domain}.scp")
        (tmp_path / f"{domain}.scp").write_text("\n".join(lines) + "\n")
    return scps


def test_cli_train_codec_cpu(tmp_path, monkeypatch, capsys):
    """``main(["train-codec", ..., "--device", "cpu"])`` on a tiny 1.0
    config with a tiny HuBERT, two synthetic domains and the full
    discriminator ensemble: three steps (the adversarial terms from step
    1), one ``metrics.jsonl`` record a step, checkpoints at steps 2 and 3
    holding "gen", "disc" and "step". The step-3 generator then goes
    through ``main(["codec", "--ckpt", ...])``: its codes equal JAX's
    ``HCodec.encode`` on the same weights (carried back to JAX) and the
    features ``codec`` computed."""
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.data.audio_io import write_wav
    from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl

    cfg = small10()
    ssl = dict(hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=32, conv_dim=[16] * 7,
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    config = {
        "model": "hcodec10", "seed": 1, "batch_size": 2,
        "segment_samples": L, "max_steps": 3, "log_every": 1,
        "save_every": 2, "ckpt_dir": str(tmp_path / "ckpt"),
        "codec": {k: v for k, v in dataclasses.asdict(small10()).items()
                  if k in ("latent_dim", "seanet_filters", "codebook_size",
                           "num_quantizers", "decoder_dim",
                           "decoder_intermediate_dim",
                           "decoder_convnext_layers",
                           "semantic_encode_channels", "feat_dim")},
        "ssl": ssl, "train": {"perceptual_start_step": 1},
        "dataset": {"domain_scps": {d: [p] for d, p in write_domains(
            tmp_path, write_wav).items()}, "num_workers": 1,
            "samples_per_epoch": 8}}
    path = tmp_path / "codec.yaml"
    path.write_text(json.dumps(config))
    trainer = cli.main(["train-codec", "--config", str(path), "--device",
                        "cpu"])
    assert trainer.step == 3
    records = [json.loads(l) for l in (tmp_path / "ckpt" / "metrics.jsonl")
               .read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in records
               for k in t_trainer.METRICS)
    assert records[0]["adv"] == 0.0 and records[2]["disc_loss"] > 0.0
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*.pt")) \
        == ["step_00000002.pt", "step_00000003.pt"]
    blob = torch.load(tmp_path / "ckpt" / "step_00000003.pt",
                      weights_only=True)
    assert set(blob) == {"gen", "disc", "step"} and blob["step"] == 3
    assert any(k.endswith(".weight_v") for k in blob["gen"])
    assert all(blob["gen"][k].item() == 1.0 for k in blob["gen"]
               if k.endswith(".initted"))

    monkeypatch.setattr(cli, "_build_hcodec", functools.partial(
        cli._build_hcodec, cfg=port_cfg(cfg),
        ssl_cfg=t_ssl.SSLConfig(**{**ssl, "conv_dim": (16,) * 7})))
    seen = []
    encode = t_codec.HCodec.encode

    def recording(self, wav, feat):
        codes = encode(self, wav, feat)
        seen.append((wav.numpy(), feat.numpy(), codes))
        return codes

    monkeypatch.setattr(t_codec.HCodec, "encode", recording)
    write_wav(tmp_path / "in.wav", batch(cfg, L, 16, b=1)[0][0], 16000)
    capsys.readouterr()
    cli.main(["codec", "--model", "hcodec10", "--input",
              str(tmp_path / "in.wav"), "--output", str(tmp_path / "o.wav"),
              "--ckpt", str(tmp_path / "ckpt" / "step_00000003.pt"),
              "--device", "cpu"])
    assert "loaded HCodec-1.0 state dict" in capsys.readouterr().err
    (wav, feat, (acoustic, semantic)), = seen
    variables = jax_variables_from(
        {k: v.numpy() for k, v in blob["gen"].items()},
        train_variables(cfg, L), t_convert.hcodec10_train_state_dict, cfg)
    want = j_codec.HCodec(cfg).apply(variables, wav, feat,
                                      method=j_codec.HCodec.encode)
    np.testing.assert_array_equal(acoustic.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(semantic.numpy(), np.asarray(want[1]))


def test_train_codec_needs_a_card(tmp_path, monkeypatch):
    """Without a card ``train-codec`` exits with an error unless given
    ``--device cpu``; a config without ``dataset`` is refused."""
    from unified_audio_tpu_torch import cli

    path = tmp_path / "c.yaml"
    path.write_text(json.dumps({"model": "hcodec10"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["train-codec", "--config", str(path)])
    with pytest.raises(SystemExit, match="'dataset' section"):
        cli.main(["train-codec", "--config", str(path), "--device", "cpu"])
