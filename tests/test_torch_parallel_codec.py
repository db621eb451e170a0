"""``CodecGANTrainer`` at dp = 2 on 2 gloo ranks
(``tests/torch_parallel_worker.py``): k-means over the latent rows
all-gathered over dp, the EMA counts and sums all-reduced, both sides'
gradients averaged over dp. Against JAX's dense generator step on the 4
clips: step 0's ``gen_loss`` within 1e-4 relative and the EMA buffers
within 1e-4 (``codebooks_close``), in fp32 and fp64, and in fp64 every
generator gradient within 1e-3 of its largest entry (``HCODEC_GRAD_TOL``);
step 1 (the GAN terms, the discriminator's update) in fp64 against the
port's single-device trainer: metrics and both sides' gradients within
1e-6. The draws (k-means' rows, the dropout cutoffs) are JAX's, handed
to every rank alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from test_torch_codec_train import (HCODEC_GRAD_TOL, batch, codebooks_close,
                                    port_codec, small10, train_export,
                                    train_variables)
from test_torch_parallel import of, rel_close, spawn
from unified_audio_tpu.models.hcodec import codec as j_codec
from unified_audio_tpu.ops import quant as j_quant
from unified_audio_tpu.train import discriminators as j_disc
from unified_audio_tpu_torch.ops import quant as t_quant
from unified_audio_tpu_torch.train.discriminators import CodecDiscriminator

CODEC_B = 4  # 2 clips a dp rank: 16 latent rows each, 32 for k-means


def record_jax_draws(step):
    """Run ``step()`` with JAX's k-means rows and scalar draws recorded, in
    program order -> (result, {"draws.rows.i": ..., "draws.cut.i": ...})."""
    record = []
    kmeans, randint = j_quant.kmeans, jax.random.randint

    def recording_kmeans(key, samples, num_clusters, num_iters=10):
        m = samples.shape[0]
        idx = (jax.random.permutation(key, m)[:num_clusters]
               if m >= num_clusters
               else randint(key, (num_clusters,), 0, m))
        jax.debug.callback(lambda x: record.append(("rows", np.asarray(x))),
                           idx, ordered=True)
        return kmeans(key, samples, num_clusters, num_iters)

    def recording_randint(key, shape, minval, maxval, *a, **kw):
        out = randint(key, shape, minval, maxval, *a, **kw)
        if tuple(shape) == ():
            jax.debug.callback(
                lambda x: record.append(("cut", np.asarray(x))), out,
                ordered=True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_quant, "kmeans", recording_kmeans)
        mp.setattr(jax.random, "randint", recording_randint)
        out = step()
        jax.effects_barrier()
    draws = {}
    for kind in ("rows", "cut"):
        for i, x in enumerate(x for k, x in record if k == kind):
            draws[f"draws.{kind}.{i}"] = x
    return out, draws


@pytest.fixture(scope="module")
def codec_case():
    """JAX's dense generator step 0 (loss, gradients, EMA buffers, in the
    port's layout) and the draws it made."""
    cfg = small10()
    variables = train_variables(cfg, 640 * 8)
    wav, feat = batch(cfg, 640 * 8, 21, b=CODEC_B)
    jcodec = j_codec.HCodec(cfg)

    @jax.jit
    def step(params, codebook):
        def f(p):
            (recon, pred, commit), mut = jcodec.apply(
                {"params": p, "codebook": codebook}, wav[..., None], feat,
                train=True, mutable=["codebook"],
                rngs={"quant": jax.random.PRNGKey(3)})
            target = wav[:, :recon.shape[-1]]
            loss = (15.0 * j_disc.multiscale_mel_loss(target, recon,
                                                      cfg.sample_rate)
                    + commit + jnp.mean(jnp.abs(pred - feat)))
            return loss, mut["codebook"]
        return jax.value_and_grad(f, has_aux=True)(params)

    ((loss, codebook), grads), draws = record_jax_draws(
        lambda: step(variables["params"], variables["codebook"]))
    want = train_export(cfg)({"params": jax.device_get(grads),
                              "codebook": jax.device_get(codebook)}, cfg)
    torch.manual_seed(0)
    return dict(cfg=cfg, variables=variables, wav=wav, feat=feat,
                loss=float(loss), want=want, draws=draws,
                disc=CodecDiscriminator().state_dict())


@pytest.fixture(scope="module")
def world2(codec_case, tmp_path_factory):
    c = codec_case
    arrays = {f"codec.gen.{k}": np.asarray(v) for k, v in
              train_export(c["cfg"])(c["variables"], c["cfg"]).items()}
    arrays.update({f"codec.disc.{k}": v.numpy()
                   for k, v in c["disc"].items()})
    arrays.update({"codec.wav": c["wav"], "codec.feat": c["feat"],
                   **c["draws"]})
    cfg = dataclasses.asdict(c["cfg"])
    scenarios = [
        dict(kind="codec", name="codec64", mesh={"dp": 2}, cfg=cfg,
             dtype="float64", steps=2),
        dict(kind="codec", name="codec32", mesh={"dp": 2}, cfg=cfg,
             dtype="float32", steps=1),
    ]
    return spawn(tmp_path_factory.mktemp("codec") / "job", 2, scenarios,
                 arrays)


def test_codec_dp2_step0_matches_jax_dense(world2, codec_case):
    """dp = 2, 2 clips a rank, the port in fp64: the generator loss (the dp
    average) within 1e-4 relative of JAX's on the 4 clips, every gradient
    (averaged over dp) within 1e-3 of its largest entry, the EMA buffers
    (k-means over the 32 gathered rows, the counts and sums all-reduced)
    within 1e-4. fp64 on the port's side, as in
    ``test_torch_causal_train.py``: at 4 clips each side's fp32 rounding
    reaches ~1e-3 of the largest entry on its own (1.5e-3 for the port's
    single-device fp32 run in the decoder's head)."""
    _assert_step0(world2, codec_case, "codec64", grads=True)


def test_codec_dp2_fp32_step0_matches_jax_dense(world2, codec_case):
    """The same step in fp32, as training runs: loss and EMA buffers."""
    _assert_step0(world2, codec_case, "codec32", grads=False)


def _assert_step0(results, c, name, grads):
    buffers = {k for k in c["want"] if "._codebook." in k}
    for r in results:
        res = of(r, name)
        got = res["step0/gen_loss"]
        assert abs(got - c["loss"]) <= 1e-4 * abs(c["loss"]), (got,
                                                               c["loss"])
        if grads:
            rel_close({k[len("step0/grad/"):]: v for k, v in res.items()
                       if k.startswith("step0/grad/")},
                      {k: v for k, v in c["want"].items()
                       if k not in buffers}, HCODEC_GRAD_TOL, "gen")
        codebooks_close({k[len("step0/buffers/"):]: torch.as_tensor(
            v).float() for k, v in res.items()
            if k.startswith("step0/buffers/")},
            {k: c["want"][k] for k in buffers}, tol=1e-4)


@pytest.fixture(scope="module")
def codec_world1(codec_case):
    """The port's single-device trainer in fp64 over the same two steps,
    draws and batch: metrics and the gradients of both sides."""
    from unified_audio_tpu_torch.train.codec_trainer import (
        CodecGANTrainer, CodecTrainConfig)

    c = codec_case
    f64 = torch.float64
    codec = port_codec(c["cfg"], c["variables"]).to(f64)
    disc = CodecDiscriminator()
    disc.load_state_dict(c["disc"])
    trainer = CodecGANTrainer(codec, CodecTrainConfig(
        perceptual_start_step=1), disc.to(f64),
        torch.Generator().manual_seed(0))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_quant, "sample_rows", t_quant.sample_rows)
        mp.setattr(t_quant, "dropout_cutoff", t_quant.dropout_cutoff)
        worker.hand_draws(t_quant, c["draws"])
        rec = worker.GradRecorder()
        try:
            for step in range(2):
                out[step] = trainer.train_step(
                    torch.as_tensor(c["wav"], dtype=f64),
                    torch.as_tensor(c["feat"], dtype=f64))
        finally:
            rec.close()
    out["gen"] = rec.named(1, codec, trainer.gen_opt, None)
    out["disc"] = rec.named(2, disc, trainer.disc_opt, None)
    return out


def test_codec_dp2_step1_matches_world_one(world2, codec_world1):
    """Step 1 adds the adversarial terms and updates the discriminator; in
    fp64 the dp = 2 run equals the single-device one but for the order of
    its sums: metrics within 1e-6 relative, the generator's and the
    discriminator's gradients within 1e-6 of their largest entry."""
    results = world2
    for r in results:
        res = of(r, "codec64")
        assert res["step1/adv"] != 0.0 and res["step1/disc_loss"] != 0.0
        for k, w in codec_world1[1].items():
            assert abs(res[f"step1/{k}"] - w) <= 1e-6 * abs(w), (k, w)
        for side, key in (("grad", "gen"), ("disc_grad", "disc")):
            got = {k[len(f"step1/{side}/"):]: v for k, v in res.items()
                   if k.startswith(f"step1/{side}/")}
            rel_close(got, {k: v.numpy()
                            for k, v in codec_world1[key].items()},
                      1e-6, key)
