"""One rank of the port's parallel tests (``tests/test_torch_parallel*.py``).

Run as ``python tests/torch_parallel_worker.py JOB_DIR RANK WORLD``, one
process a rank: the process joins a gloo group through
``parallel/distributed.py initialize`` (its own timeout, so a hung
collective ends the process instead of the whole test run) over a
``TCPStore`` that rank 0 binds to port 0 and whose port it publishes as
``JOB_DIR/port``, so no other process can take the port between its
choice and its bind; it runs the scenarios of ``JOB_DIR/job.json`` in
order over the arrays of ``JOB_DIR/inputs.npz`` (weights in the port's
state-dict layout, batches, draws), and writes its results to ``JOB_DIR/out_rank{RANK}.npz`` under
"<scenario>/<key>". Gradients and weights are written whole (gathered
over tp and pp), in the single-device layout.

This file imports torch, numpy and the port, never JAX: the tests compute
JAX's dense results in their own process and compare.
"""
import dataclasses
import json
import sys
import time
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from unified_audio_tpu_torch.parallel import distributed  # noqa: E402
from unified_audio_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from unified_audio_tpu_torch.train import optim as t_optim  # noqa: E402


# ---------------------------------------------------------------------------
# Building the port's modules from the job's configs and arrays
# ---------------------------------------------------------------------------

def config(cls, d):
    """A config dataclass from its JSON dict (lists back to tuples)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in fields})


def state(arrays, prefix):
    return {k[len(prefix):]: torch.as_tensor(v) for k, v in arrays.items()
            if k.startswith(prefix)}


def llama_config(d):
    from unified_audio_tpu_torch.models.lm.llama import LlamaConfig

    return config(LlamaConfig, d)


def build_unise(cfgs, arrays):
    """The tiny training UniSE of the tests (fp32, CPU)."""
    from unified_audio_tpu_torch.models.bicodec.bicodec import (BiCodec,
                                                                 BiCodecConfig)
    from unified_audio_tpu_torch.models.bicodec.tokenizer import (
        BiCodecTokenizer)
    from unified_audio_tpu_torch.models.lm.sft import LLMSFT
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import (SSLConfig,
                                                             Wav2Vec2Model)
    from unified_audio_tpu_torch.models.unise.model import (UniSE,
                                                            UniSEConfig)

    llm = llama_config(cfgs["unise"]["llm"])
    ucfg = config(UniSEConfig, {**cfgs["unise"], "llm": llm})
    bicodec = BiCodec(config(BiCodecConfig, cfgs["bicodec"]), tokenize=True)
    bicodec.load_state_dict(state(arrays, "bicodec."))
    xlsr = Wav2Vec2Model(config(SSLConfig, cfgs["xlsr"]))
    xlsr.load_state_dict(state(arrays, "xlsr."))
    wavlm = Wav2Vec2Model(config(SSLConfig, cfgs["wavlm"]))
    wavlm.load_state_dict(state(arrays, "wavlm."))
    sft = LLMSFT(llm, num_tasks=3, feats_dim=ucfg.feats_dim)
    sft.load_state_dict(state(arrays, "sft."))
    return UniSE(ucfg, BiCodecTokenizer(bicodec, xlsr).eval(), wavlm.eval(),
                 sft.eval())


class GradRecorder:
    """Records the gradients each global-norm clip is given (after the
    optimizer's dp average) and what it makes of them."""

    def __init__(self):
        self.calls, self.clipped = [], []
        self._clip = t_optim.clip_by_global_norm_

        def rec(grads, max_norm, split=(), group=None):
            grads, split = list(grads), list(split)
            self.calls.append([g.clone() for g in (*grads, *split)])
            out = self._clip(grads, max_norm, split, group)
            self.clipped.append([g.clone() for g in (*grads, *split)])
            return out

        t_optim.clip_by_global_norm_ = rec

    def close(self):
        t_optim.clip_by_global_norm_ = self._clip

    def named(self, call, model, optimizer, mesh, num_layers=0,
              clipped=False):
        """Call ``call``'s gradients by parameter name, whole: as the clip
        was given them, or with ``clipped`` as it left them."""
        from unified_audio_tpu_torch.train.checkpoint import _param_names

        names = _param_names(model, optimizer)
        split = [getattr(p, "mp_split", False) for p in optimizer.params]
        order = ([n for n, s in zip(names, split) if not s]
                 + [n for n, s in zip(names, split) if s])
        grads = dict(zip(order, (self.clipped if clipped
                                 else self.calls)[call]))
        return mesh_lib.gather_named(grads, dict(model.named_parameters()),
                                     mesh, num_layers)


def prefixed(prefix, tensors):
    """Copies (a state dict's tensors are the live buffers)."""
    return {f"{prefix}{k}": v.detach().numpy().copy()
            for k, v in tensors.items()}


def raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def mesh_of(sc):
    return mesh_lib.make_mesh_axes(**sc["mesh"])


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def sft_step(sc, arrays, job_dir, rank):
    """One ``SFTTrainer`` step of the tiny UniSE on a dp x tp or (dp x) pp
    mesh over the global batch ``batch.*``: loss, accuracy, every LM
    gradient before and after the global-norm clip (at "grad_clip" when
    given), the weights after the step; with "save" the gathered
    checkpoint; with "load" a single-device checkpoint loaded, then
    gathered again."""
    from unified_audio_tpu_torch.train.checkpoint import CheckpointManager
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer

    mesh = mesh_of(sc)
    unise = build_unise(sc["cfgs"], arrays)
    clip = dict(grad_clip=sc["grad_clip"]) if "grad_clip" in sc else {}
    opt = t_optim.Optimizer(unise.sft.parameters(), warmup_steps=sc["warmup"],
                            **clip)
    kw = ({"pp_mesh": mesh, "pp_microbatches": sc["microbatches"]}
          if "pp" in sc["mesh"] else {"mesh": mesh})
    trainer = SFTTrainer(unise, opt, **kw)
    rec = GradRecorder()
    try:
        batch = [None if f"batch.{k}" not in arrays else
                 mesh_lib.shard_batch(torch.as_tensor(arrays[f"batch.{k}"]),
                                      mesh)
                 for k in ("enroll", "mix", "target")]
        loss, acc = trainer.train_step(sc["task"], *batch)
    finally:
        rec.close()
    layers = unise.sft.cfg.num_layers
    out = {"loss": np.float64(loss), "acc": np.float64(acc)}
    out.update(prefixed("grad/", rec.named(0, unise.sft, opt, mesh, layers)))
    out.update(prefixed("clipped/", rec.named(0, unise.sft, opt, mesh, layers,
                                              clipped=True)))
    blob = trainer.state_dict()
    out.update(prefixed("param/", blob["state_dict"]))
    if sc.get("save") and rank == 0:
        CheckpointManager(job_dir / sc["save"]).save(trainer.step, blob)
    if sc.get("load"):
        unise2 = build_unise(sc["cfgs"], arrays)
        opt2 = t_optim.Optimizer(unise2.sft.parameters(),
                                 warmup_steps=sc["warmup"], **clip)
        t2 = SFTTrainer(unise2, opt2, **kw)
        t2.load_state_dict(torch.load(job_dir / sc["load"],
                                      weights_only=True))
        again = t2.state_dict()
        out.update(prefixed("loaded/", again["state_dict"]))
        for i, s in again["optimizer"]["adamw"]["state"].items():
            out[f"loaded_m/{i}"] = s["exp_avg"].numpy()
            out[f"loaded_v/{i}"] = s["exp_avg_sq"].numpy()
        out["loaded_step"] = np.int64(again["step"])
    return out


def pipeline(sc, arrays, job_dir, rank):
    """``llama_pipeline_forward`` of a tiny backbone then the final norm,
    the loss mean(y^2) and its gradients (layers, norm, the input); and
    the refusal of a microbatch count that does not divide the batch."""
    from unified_audio_tpu_torch.models.lm.llama import LlamaBackbone
    from unified_audio_tpu_torch.parallel.pipeline import (
        llama_pipeline_forward, shard_stages_)

    mesh = mesh_of(sc)
    cfg = llama_config(sc["cfg"])
    bb = LlamaBackbone(cfg)
    bb.load_state_dict(state(arrays, f"{sc['name']}.backbone."))
    shard_stages_(bb, mesh)
    embeds = torch.as_tensor(arrays[f"{sc['name']}.embeds"]).requires_grad_()
    y = bb.norm(llama_pipeline_forward(bb, embeds, mesh, sc["microbatches"]))
    y.square().mean().backward()
    grads = mesh_lib.gather_named(
        {n: p.grad for n, p in bb.named_parameters()},
        dict(bb.named_parameters()), mesh, cfg.num_layers)
    out = {"y": y.detach().numpy(), "embeds_grad": embeds.grad.numpy()}
    out.update(prefixed("grad/", grads))
    out["bad_microbatches_raises"] = np.bool_(raises(
        lambda: llama_pipeline_forward(bb, embeds, mesh, 3)))
    return out


def sequence(sc, arrays, job_dir, rank):
    """``llama_sequence_parallel_forward`` of a tiny backbone then the final
    norm; and the refusal of a sequence the axis does not divide."""
    from unified_audio_tpu_torch.models.lm.llama import LlamaBackbone
    from unified_audio_tpu_torch.parallel.sequence import (
        llama_sequence_parallel_forward)

    mesh = mesh_of(sc)
    cfg = llama_config(sc["cfg"])
    bb = LlamaBackbone(cfg)
    bb.load_state_dict(state(arrays, f"{sc['name']}.backbone."))
    embeds = torch.as_tensor(arrays[f"{sc['name']}.embeds"])
    with torch.no_grad():
        y = bb.norm(llama_sequence_parallel_forward(bb, embeds, mesh))
    ragged = torch.zeros(1, embeds.shape[1] + 2, cfg.hidden_size)
    return {"y": y.numpy(), "ragged_raises": np.bool_(raises(
        lambda: llama_sequence_parallel_forward(bb, ragged, mesh)))}


def pretrain(sc, arrays, job_dir, rank):
    """One ``PretrainTrainer`` step on a dp x tp mesh over the global batch:
    loss, accuracy, every gradient."""
    from unified_audio_tpu_torch.models.lm.llama import CodecLM
    from unified_audio_tpu_torch.train.pretrain import PretrainTrainer

    mesh = mesh_of(sc)
    cfg = llama_config(sc["cfg"])
    model = CodecLM(cfg)
    model.load_state_dict(state(arrays, "pretrain.lm."))
    opt = t_optim.Optimizer(model.parameters(), warmup_steps=2)
    trainer = PretrainTrainer(cfg, model, opt, device="cpu", mesh=mesh)
    rec = GradRecorder()
    try:
        loss, acc = trainer.train_step(
            *(mesh_lib.shard_batch(torch.as_tensor(arrays[f"pretrain.{k}"]),
                                   mesh) for k in ("g", "s")))
    finally:
        rec.close()
    out = {"loss": np.float64(loss), "acc": np.float64(acc)}
    out.update(prefixed("grad/", rec.named(0, model, opt, mesh,
                                           cfg.num_layers)))
    return out


def paged(sc, arrays, job_dir, rank):
    """One tensor-parallel paged decode step of a tiny LM (its heads and
    pool rows cut over tp), in the plain and owner modes: the logits and
    the pool, gathered."""
    from unified_audio_tpu_torch.models.lm.sft import LLMSFT
    from unified_audio_tpu_torch.serve.paged import (init_pool,
                                                     paged_decode_ids)

    mesh = mesh_of(sc)
    tp, group = mesh_lib.axis_size(mesh, "tp"), mesh_lib.axis_group(mesh, "tp")
    cfg = llama_config(sc["cfg"])
    a = {k[len("paged."):]: torch.as_tensor(v) for k, v in arrays.items()
         if k.startswith("paged.") and not k.startswith("paged.lm.")}
    out = {}
    for mode in ("", "owner"):
        sft = LLMSFT(cfg, num_tasks=3, feats_dim=sc["feats_dim"])
        sft.load_state_dict(state(arrays, "paged.lm."))
        mesh_lib.shard_lm_(sft, mesh)
        nb, bs = a["k"].shape[1], a["k"].shape[2]
        pool = init_pool(cfg, nb, bs, tp=tp)
        for key in ("k", "v"):
            pool[key].copy_(mesh_lib.shard_tensor(a[key], 3, mesh))
        with torch.no_grad():
            logits = paged_decode_ids(cfg, sft, pool, a["tables"].int(),
                                      a["index"].int(), a["active"].bool(),
                                      a["ids"], bs, use_kernel=mode)
        tag = mode or "plain"
        out[f"{tag}/logits"] = logits.numpy()
        out[f"{tag}/heads"] = np.int64(sft.layers[0].self_attn.local_heads)
        for key in ("k", "v"):
            whole = (pool[key] if group is None
                     else mesh_lib.unshard_tensor(pool[key], 3, group))
            out[f"{tag}/{key}"] = whole.numpy()
    return out


def codec(sc, arrays, job_dir, rank):
    """One or two ``CodecGANTrainer`` steps on a dp mesh over the global
    batch, in the scenario's dtype (step 0 reconstructs; step 1 adds the
    GAN terms and updates the discriminator), k-means' rows and the first
    cutoffs handed in from ``draws.*``: each step's metrics, the
    generator's gradients of each step and the discriminator's of step 1,
    the EMA buffers after each step."""
    from unified_audio_tpu_torch.models.hcodec.codec import (HCodec,
                                                             HCodecConfig)
    from unified_audio_tpu_torch.ops import quant
    from unified_audio_tpu_torch.train.codec_trainer import (
        CodecGANTrainer, CodecTrainConfig)
    from unified_audio_tpu_torch.train.discriminators import (
        CodecDiscriminator)

    hand_draws(quant, arrays)
    mesh = mesh_of(sc)
    dtype = getattr(torch, sc["dtype"])
    codec_ = HCodec(config(HCodecConfig, sc["cfg"]), trainable=True)
    codec_.load_state_dict(state(arrays, "codec.gen."))
    disc = CodecDiscriminator()
    disc.load_state_dict(state(arrays, "codec.disc."))
    trainer = CodecGANTrainer(
        codec_.to(dtype), CodecTrainConfig(perceptual_start_step=1),
        disc.to(dtype), torch.Generator().manual_seed(0), mesh=mesh)
    wav, feat = (mesh_lib.shard_batch(torch.as_tensor(
        arrays[f"codec.{k}"], dtype=dtype), mesh) for k in ("wav", "feat"))
    rec = GradRecorder()
    out = {}
    try:
        for step in range(sc["steps"]):
            metrics = trainer.train_step(wav, feat)
            for k, v in metrics.items():
                out[f"step{step}/{k}"] = np.float64(v)
            out.update(prefixed(f"step{step}/buffers/", {
                k: v for k, v in codec_.state_dict().items()
                if "._codebook." in k}))
    finally:
        rec.close()
    out.update(prefixed("step0/grad/", rec.named(0, codec_, trainer.gen_opt,
                                                 mesh)))
    if sc["steps"] > 1:
        out.update(prefixed("step1/grad/", rec.named(
            1, codec_, trainer.gen_opt, mesh)))
        out.update(prefixed("step1/disc_grad/", rec.named(
            2, disc, trainer.disc_opt, mesh)))
    return out


def hand_draws(quant, arrays):
    """The port's k-means rows and dropout cutoffs are handed in order from
    ``draws.rows.{i}`` and ``draws.cut.{i}`` while they last, then drawn
    from the generator as usual (every rank alike)."""
    rows = [arrays[f"draws.rows.{i}"] for i in range(
        sum(k.startswith("draws.rows.") for k in arrays))]
    cuts = [int(arrays[f"draws.cut.{i}"]) for i in range(
        sum(k.startswith("draws.cut.") for k in arrays))]
    sample_rows, dropout_cutoff = quant.sample_rows, quant.dropout_cutoff

    def rows_(m, num, generator=None):
        if rows:
            return torch.as_tensor(np.array(rows.pop(0))).long()
        return sample_rows(m, num, generator)

    def cut_(nq, generator=None):
        return cuts.pop(0) if cuts else dropout_cutoff(nq, generator)

    quant.sample_rows, quant.dropout_cutoff = rows_, cut_


def data(sc, arrays, job_dir, rank):
    """The first ``batches`` batches of ``TrainDataIterator`` on this rank's
    dp shard of the mesh, with the job's worker threads, as
    ``share_batches`` hands them to the rank (the way ``cli train-unise``
    feeds its trainer), and the iterator's shard."""
    import itertools

    from unified_audio_tpu_torch.data.data_module import (Prefetcher,
                                                          TrainDataIterator)

    mesh = mesh_of(sc)
    index, count = mesh_lib.dp_shard(mesh)
    it = TrainDataIterator(**sc["dataset"], process_index=index,
                           process_count=count)
    out = {"shard": np.array([it.rank, it.world_size])}
    batches = mesh_lib.share_batches(Prefetcher(it, "cpu"), mesh)
    for i, (mode, enroll, mix, speech, *_) in enumerate(
            itertools.islice(batches, sc["batches"])):
        out.update({f"{i}/mode": np.array(mode), f"{i}/mix": mix.numpy(),
                    f"{i}/speech": speech.numpy()})
    batches.close()
    return out


def hybrid(sc, arrays, job_dir, rank):
    """``make_hybrid_mesh``: an ici-only mesh, a dcn axis merged with the
    ici one of its name, and the refusal of a wrong size."""
    import warnings

    from unified_audio_tpu_torch.parallel.distributed import make_hybrid_mesh

    flat = make_hybrid_mesh(ici=dict(dp=2, tp=2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        merged = make_hybrid_mesh(ici=dict(dp=1, tp=2), dcn=dict(dp=2))
    return {
        "flat_shape": np.array([mesh_lib.axis_size(flat, n)
                                for n in ("dp", "tp")]),
        "merged_shape": np.array([mesh_lib.axis_size(merged, n)
                                  for n in ("dp", "tp")]),
        "merged_names": np.array(merged.mesh_dim_names),
        "merged_warned": np.bool_(any("placement-unaware" in str(w.message)
                                      for w in caught)),
        "coords": np.array([mesh_lib.axis_rank(merged, "dp"),
                            mesh_lib.axis_rank(merged, "tp")]),
        "wrong_size_raises": np.bool_(raises(
            lambda: make_hybrid_mesh(ici=dict(dp=3, tp=2)))),
    }


def moe_ep(sc, arrays, job_dir, rank):
    """Expert parallelism: HCodec's MoE ``Transformer`` (``sc["kw"]``) on
    a dp x tp mesh, the experts cut over tp (``EXPERT_RULES``), each dp
    rank on its rows of ``x``: the output gathered over dp, and the
    gradients of mean(y^2) averaged over dp and gathered over tp; beside
    them the same model replicated on the whole batch in this process."""
    from unified_audio_tpu_torch.nn.transformer import Transformer

    def model():
        m = Transformer(**sc["kw"])
        m.load_state_dict(state(arrays, "moe.model."))
        return m

    x = torch.as_tensor(arrays["moe.x"])
    out = {}
    ref = model()
    xr = x.clone().requires_grad_(True)
    y = ref(xr)
    y.square().mean().backward()
    out["ref/y"] = y.detach().numpy()
    out["ref/x_grad"] = xr.grad.numpy()
    out.update(prefixed("ref/grad/", {k: p.grad for k, p in
                                      ref.named_parameters()
                                      if p.grad is not None}))
    mesh = mesh_of(sc)
    ep = mesh_lib.shard_lm_(model(), mesh, rules=mesh_lib.EXPERT_RULES)
    w1 = ep.layers[0].mlp.expert_w1
    out["local_experts"] = np.int64(w1.shape[0])
    xl = mesh_lib.shard_batch(x, mesh).clone().requires_grad_(True)
    y = ep(xl)
    y.square().mean().backward()
    dp_group, dp = mesh_lib.axis_group(mesh, "dp"), mesh_lib.axis_size(
        mesh, "dp")
    # the global mean's gradient on x: this rank's rows' gradient / dp
    out["ep/x_grad"] = (mesh_lib.unshard_tensor(xl.grad, 0, dp_group)
                        / dp).numpy()
    params = dict(ep.named_parameters())
    grads = {k: p.grad for k, p in params.items() if p.grad is not None}
    mesh_lib.all_reduce_mean_(list(grads.values()), dp_group)
    out.update(prefixed("ep/grad/", mesh_lib.gather_named(grads, params,
                                                          mesh, 0)))
    out["ep/y"] = mesh_lib.unshard_tensor(y.detach(), 0, dp_group).numpy()
    return out


SCENARIOS = {"sft": sft_step, "pipeline": pipeline, "sequence": sequence,
             "pretrain": pretrain, "paged": paged, "codec": codec,
             "data": data, "hybrid": hybrid, "moe_ep": moe_ep}


def rendezvous(job_dir: Path, rank: int, world: int, timeout: timedelta):
    """The group's store: rank 0 binds a ``TCPStore`` to a port the system
    picks and writes the port to ``JOB_DIR/port`` (a new name, renamed into
    place); the other ranks wait for that file and connect."""
    port_file = job_dir / "port"
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                              timeout=timeout, wait_for_workers=False)
        tmp = job_dir / "port.tmp"
        tmp.write_text(str(store.port))
        tmp.rename(port_file)
        return store
    deadline = time.monotonic() + timeout.total_seconds()
    while not port_file.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank 0 published no port in {timeout}")
        time.sleep(0.05)
    return dist.TCPStore("127.0.0.1", int(port_file.read_text()), world,
                         is_master=False, timeout=timeout)


def main(job_dir: Path, rank: int, world: int):
    torch.set_num_threads(1)  # several ranks share the machine's cores
    job = json.loads((job_dir / "job.json").read_text())
    arrays = dict(np.load(job_dir / "inputs.npz"))
    timeout = timedelta(seconds=job.get("timeout_s", 120))
    store = rendezvous(job_dir, rank, world, timeout)
    assert distributed.initialize(None, world, rank, device="cpu",
                                  timeout=timeout, store=store)
    out = {}
    try:
        for sc in job["scenarios"]:
            res = SCENARIOS[sc["kind"]](sc, arrays, job_dir, rank)
            out.update({f"{sc['name']}/{k}": v for k, v in res.items()})
            dist.barrier()
    finally:
        np.savez(job_dir / f"out_rank{rank}.npz", **out)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
