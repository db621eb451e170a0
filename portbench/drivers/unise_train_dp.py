"""UniSE SFT training at dp = ``world`` over NCCL, one rank a card: the
unise training cell's step (``unise_train.py``: its data, loader, batch,
optimizer resumed at the schedule's peak, fp32 with TF32 off) on every
rank, ``cli train-unise``'s dp mesh (``parallel/mesh.py make_mesh``), each
rank drawing its own batches (``process_index`` / ``process_count``), the
gradients averaged over the ranks by the optimizer
(``parallel/mesh.py all_reduce_mean_``) before the clip.

Rank 0 is ``run.py``'s process: its set-up writes the corpus, starts
ranks 1 to ``world - 1`` (this file run as a module, their output on
standard error), and joins them through a store on a free port. Every rank
then runs the same set-up, window and check, rank 0 deciding when the
window closes (a flag sent each step on a gloo group beside NCCL's); the
others stop with it. Only rank 0 profiles and counts. The rate counts the
global batch: ``world`` x 32 x 5 s a step.

The check is the training cell's (``unise_train.check``) on the global
batch: each rank's reference follows its own first three batches, its
gradients averaged over the ranks (summed by NCCL, divided by the world)
before the clip, the losses averaged and the token counts summed; rank 0
holds them to the program's dp-mean losses, first gradient and changes.
"""
from __future__ import annotations

import argparse
import atexit
import shutil
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench.drivers import unise_train as base

TIMEOUT_S = 600  # a collective that waits longer ends the rank


def _port():
    p = base._port()
    import torch.distributed as dist

    from unified_audio_tpu_torch.parallel import distributed, mesh
    p.dist, p.distributed, p.mesh = dist, distributed, mesh
    return p


def corpus_root() -> Path:
    import tempfile

    return Path(tempfile.gettempdir()) / "portbench-unise-train-dp"


def store(torch, rank: int, world: int, port: int = 0):
    """The group's store: rank 0 binds it (port 0: a free one, read back
    as ``.port``), the others connect to rank 0's port."""
    return torch.distributed.TCPStore(
        "localhost", port, world, is_master=rank == 0,
        timeout=timedelta(seconds=TIMEOUT_S), wait_for_workers=False)


def join(run, p, rank: int, world: int, group_store):
    """This rank in the default group (NCCL on the card, gloo on the CPU)
    through ``group_store``, and a gloo group beside it for the window's
    flag and the check's sums."""
    p.distributed.initialize(None, world, rank, device=(
        "cpu" if run.device == "cpu" else "cuda"), store=group_store,
        timeout=timedelta(seconds=TIMEOUT_S))
    run.rank, run.world = rank, world
    run.control = p.dist.new_group(backend="gloo")


def setup(run):
    """Rank 0: the corpus, the other ranks started and joined, then
    :func:`setup_rank`."""
    torch, world = run.torch, run.entry["chips"]
    p = _port()
    base.write_corpus(run, corpus_root())
    master = store(torch, 0, world)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.drivers.unise_train_dp",
         "--rank", str(r), "--world", str(world), "--port", str(master.port),
         "--workload", run.entry["name"], "--seed", str(run.seed),
         "--seconds", str(run.seconds), "--trace", str(int(run.trace))],
        cwd=str(Path(__file__).resolve().parents[2]), stdout=sys.stderr)
        for r in range(1, world)]
    atexit.register(_reap, procs)
    try:
        join(run, p, 0, world, master)
        st = setup_rank(run, p)
    except BaseException:
        _reap(procs, grace=0.0)
        raise
    st.procs = procs
    return st


def _reap(procs, grace: float = 60.0):
    """Wait up to ``grace`` seconds for the other ranks, then end them."""
    end = time.monotonic() + grace
    for proc in procs:
        try:
            proc.wait(max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()


def all_true(run, flag: bool) -> bool:
    """Whether ``flag`` holds on every rank."""
    t = run.torch.tensor([int(flag)])
    run.torch.distributed.all_reduce(t, op=run.torch.distributed.ReduceOp.MIN,
                                     group=run.control)
    return bool(t.item())


def sums(run, values):
    """``values`` (floats) summed over the ranks, in fp64."""
    t = run.torch.tensor(values, dtype=run.torch.float64)
    run.torch.distributed.all_reduce(t, group=run.control)
    return t.tolist()


def setup_rank(run, p):
    """The training cell's set-up on this rank (``unise_train.setup``) with
    the dp mesh, this rank's share of the data, and the first steps run
    until every rank has seen every task."""
    torch = run.torch
    ref, unise = base.build(run, p)
    root = corpus_root()
    scps = {f"{k}_scp": [str(root / f"{k}.scp")]
            for k in ("speech", "noise", "rir")}
    dev = (run.device if run.device == "cpu"
           else f"cuda:{torch.cuda.current_device()}")
    data = p.Prefetcher(p.TrainDataIterator(
        **scps, **run.cell["dataset"], seed=run.seed % 2 ** 31,
        process_index=run.rank, process_count=run.world), dev)
    opt = p.Optimizer(unise.sft.parameters(), **run.cell["opt"])
    base.resume_schedule(opt, run.cell["schedule_start"])
    trainer = p.SFTTrainer(unise, opt, mesh=p.mesh.make_mesh(run.world, 1))
    st = SimpleNamespace(p=p, ref=ref, unise=unise, trainer=trainer,
                         feed=iter(data), first=[], by_mode={})
    if run.device != "cpu":
        ref.to("cpu")
        torch.cuda.empty_cache()
    real = unise.frozen_inputs
    names = [n for n, q in unise.sft.named_parameters() if q.requires_grad]
    for k in range(run.cell["first_steps"]):
        mode, enroll, mix, target = base._next(st)
        got = {}
        if k < 3:
            def frozen(*a, _got=got):
                out = real(*a)
                _got["tokens"] = (out[2].cpu(), out[3].cpu())
                return out
            unise.frozen_inputs = frozen
        loss, _ = trainer.train_step(mode, enroll, mix, target)
        unise.frozen_inputs = real
        if k < 3:
            st.first.append({"mode": mode, "loss": loss, **got,
                             "inputs": [None if x is None else x.cpu()
                                        for x in (enroll, mix, target)]})
        if k == 2:
            st.after_three = {n: q.detach().cpu().clone()
                              for n, q in zip(names, trainer.optimizer.params)}
        if k == 0:
            state = trainer.optimizer.adamw.state
            st.first_grad = {
                n: (state[q]["exp_avg"] / (1 - base.BETA1)).cpu()
                if q in state and "exp_avg" in state[q] else
                torch.zeros_like(q, device="cpu")
                for n, q in zip(names, trainer.optimizer.params)}
        if mode not in st.by_mode:
            st.by_mode[mode] = [None if x is None else x.cpu()
                                for x in (enroll, mix, target)]
        if all_true(run, k >= 2 and set(st.by_mode) >= set(
                run.cell["modes"])):
            break
    if run.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    return st


def window(run, st):
    """The training cell's window on every rank in step: rank 0's clock
    closes it, at the first step end after ``--seconds``; in a traced run
    rank 0 profiles steps ``traced_steps``."""
    torch, c = run.torch, run.cell
    lo, hi = c["traced_steps"]
    steps, modes = 0, []
    audio_s = (run.world * c["dataset"]["batch_size"]
               * c["dataset"]["cut_duration"][0])
    prof = None
    t0 = time.perf_counter()
    while True:
        if run.rank == 0 and run.trace and steps == lo:
            prof = run.profiled()
            prof.__enter__()
        if run.trace:
            modes.append(base._traced_step(run, st))
        else:
            mode, enroll, mix, target = base._next(st)
            st.trainer.train_step(mode, enroll, mix, target)
            modes.append(mode)
        steps += 1
        if prof is not None and steps == hi:
            prof.__exit__(None, None, None)
            prof = None
        more = torch.tensor([int(run.rank != 0 or prof is not None or (
            time.perf_counter() - t0 < run.seconds)
            or (run.trace and steps < hi))])
        torch.distributed.broadcast(more, 0, group=run.control)
        if not more.item():
            break
    window_s = time.perf_counter() - t0
    run.records["window_s"] = window_s
    run.records["modes"] = modes
    run.count("steps", steps)
    run.count("profiled_steps", max(0, min(steps, hi) - lo) if run.trace
              else 0)
    return {"metrics": {"train_audio_s_per_s": steps * audio_s / window_s},
            "attempted": steps, "failed": 0}


def release(run, st):
    st.trainer = st.unise = st.feed = None
    import gc

    gc.collect()
    if run.device != "cpu":
        run.torch.cuda.empty_cache()


def check(run, st, out):
    """The first three steps of the global batch against the reference
    (module docstring); every rank takes part, rank 0 reads."""
    torch, dev = run.torch, run.device
    c = run.cell
    ref = st.ref.to(dev)
    start = c["schedule_start"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm = ref.lm
    saved = {n: q.detach().clone() for n, q in lm.named_parameters()}
    params = [q for _, q in lm.named_parameters()]
    for q in params:
        q.requires_grad_(True)
    opt = torch.optim.AdamW(params, lr=1.0, betas=(base.BETA1, 0.999),
                            eps=1e-8, weight_decay=c["opt"].get(
                                "weight_decay", 0.01))
    differ = total = 0
    r_losses, r_norms, r_grads = [], [], None
    for k, step in enumerate(st.first):
        x = [None if v is None else v.to(dev) for v in step["inputs"]]
        with torch.no_grad():
            ef, mf, g, s = ref.frozen_inputs(*x)
        pg, ps = step["tokens"]
        differ += int((pg != g.cpu()).sum() + (ps != s.cpu()).sum())
        total += pg.numel() + ps.numel()
        loss = ref.sft_loss(st.p.TASK_MAP[step["mode"]], ef, mf, g, s)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        for q in params:  # a leaf the loss did not reach takes a zero
            if q.grad is None:  # gradient, as the program's optimizer
                q.grad = torch.zeros_like(q)  # gives it
        gl = [q.grad for q in params]
        flat = torch.cat([v.reshape(-1) for v in gl])
        torch.distributed.all_reduce(flat)  # the dp mean, the reference's
        flat /= run.world
        o = 0
        for v in gl:
            v.copy_(flat[o:o + v.numel()].view_as(v))
            o += v.numel()
        norm = torch.sqrt(sum(v.double().square().sum() for v in gl))
        if norm >= c["opt"]["grad_clip"]:
            for v in gl:
                v.mul_(c["opt"]["grad_clip"] / norm)
        if k == 0:
            r_grads = {n: v.detach().cpu().clone()
                       for (n, _), v in zip(lm.named_parameters(), gl)}
        r_norms.append({n: float(v.double().norm()) for (n, _), v
                        in zip(lm.named_parameters(), gl)})
        for grp in opt.param_groups:
            grp["lr"] = base.schedule(c["opt"], start + k)
        opt.step()
        r_losses.append(float(loss.detach()))
    with torch.no_grad():
        r_change = {n: (q - saved[n]).cpu() for n, q in lm.named_parameters()}
        for n, q in lm.named_parameters():
            q.copy_(saved[n])
            q.requires_grad_(False)
    r_losses = [v / run.world for v in sums(run, r_losses)]
    differ, total = sums(run, [differ, total])
    p_losses = [s["loss"] for s in st.first]
    p_change = {n: v - lm.get_parameter(n).detach().cpu()
                for n, v in st.after_three.items()}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses))
    reached = [{n for n, v in norms.items() if v >= c["check"][
        "zero_grad_share"] * float(np.median(list(norms.values())))}
        for norms in r_norms]
    gap = base.norm_gap(r_grads, st.first_grad, reached[0])
    change_gap = base.norm_gap(r_change, p_change, set().union(*reached))
    if run.trace:
        base._count(run, st, ref)
        got = run.records["counts"]
        got["fp32_flops"] = sums(run, [got.get("fp32_flops", 0)])[0]
        got["ranks"] = run.world
    if run.rank == 0:
        print(f"first steps: tasks {[s['mode'] for s in st.first]} (rank "
              f"0), dp-mean losses program {p_losses} reference "
              f"{r_losses}", file=sys.stderr)
    if run.rank == 0:
        _reap(getattr(st, "procs", ()))  # the others end after the check
        shutil.rmtree(corpus_root(), ignore_errors=True)
    return [{"name": "token_mismatch", "value": differ / max(total, 1),
             "limit": c["check"]["token_mismatch"]},
            {"name": "loss_rel_err", "value": loss_err,
             "limit": c["check"]["loss_rel_err"]},
            {"name": "grad_norm_gap", "value": gap,
             "limit": c["check"]["grad_norm_gap"]},
            {"name": "change_norm_gap", "value": change_gap,
             "limit": c["check"]["change_norm_gap"]}]


def rank_main(run, rank: int, world: int, group_store) -> list:
    """One rank's whole run: join, set up, the window, release, the check
    (rank 0 of ``run.py`` joins in ``setup`` instead)."""
    p = _port()
    join(run, p, rank, world, group_store)
    st = setup_rank(run, p)
    out = window(run, st)
    release(run, st)
    return check(run, st, out)


def main(argv=None):
    a = argparse.ArgumentParser()
    for k in ("rank", "world", "port", "seed", "trace"):
        a.add_argument(f"--{k}", type=int, required=True)
    a.add_argument("--workload", required=True)
    a.add_argument("--seconds", type=float, required=True)
    args = a.parse_args(argv)
    import torch

    from portbench.harness import manifest
    from portbench.harness.context import Run

    torch.cuda.set_device(args.rank)
    bench = manifest.load_manifest()
    entry = manifest.entry(bench["workloads"], args.workload, "workload")
    ref = manifest.load_module(manifest.reference_path(entry["config"]),
                               "reference." + entry["config"])
    run = Run(torch, args, manifest.cell_params(args.workload),
              manifest.config_params(bench, entry["config"]), entry, ref)
    rank_main(run, args.rank, args.world,
              store(torch, args.rank, args.world, args.port))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
