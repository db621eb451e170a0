"""One rank of the ``unise-train-sft-dp4`` cell's run on the CPU at tiny
sizes over gloo, for ``test_portbench_dp.py``:

    python -m portbench.tests.dp_rank JOB_DIR RANK WORLD [left_out]

Rank 0 writes the corpus, binds the group's store to a free port and
publishes it as ``JOB_DIR/port``; every rank runs the driver's set-up,
window (one step) and check; rank 0 writes the checks to
``JOB_DIR/checks.json``. ``left_out``: the last rank's gradients are left
out of the optimizer's mean (zeroed before the sum).
"""
import json
import sys
import time
from argparse import Namespace
from pathlib import Path

import torch


def main(job_dir: str, rank: int, world: int, fault: str = "") -> None:
    from portbench.drivers import unise_train_dp as drv
    from portbench.harness import manifest
    from portbench.harness.context import Run
    from portbench.tests import tiny

    torch.set_num_threads(1)
    job = Path(job_dir)
    cell = tiny.cell("unise-train-sft-b32x5s")
    cell.update(driver="unise_train_dp", first_steps=8)
    entry = dict(manifest.entry(manifest.load_manifest()["workloads"],
                                "unise-train-sft-dp4", "workload"),
                 chips=world)
    ref = manifest.load_module(manifest.reference_path("unise"),
                               "reference.unise")
    run = Run(torch, Namespace(seed=5, seconds=0.0, trace=0), cell,
              tiny.config("unise"), entry, ref, device="cpu")
    if fault == "left_out" and rank == world - 1:
        from unified_audio_tpu_torch.train import optim
        real = optim.all_reduce_mean_

        def left_out(tensors, group):
            for t in tensors:
                t.zero_()
            real(tensors, group)
        optim.all_reduce_mean_ = left_out
    if rank == 0:
        from portbench.drivers import unise_train

        unise_train.write_corpus(run, drv.corpus_root())
        store = drv.store(torch, 0, world)
        (job / "port.tmp").write_text(str(store.port))
        (job / "port.tmp").rename(job / "port")
    else:
        while not (job / "port").exists():
            time.sleep(0.1)
        store = drv.store(torch, rank, world, int((job / "port").read_text()))
    checks = drv.rank_main(run, rank, world, store)
    if rank == 0:
        (job / "checks.json").write_text(json.dumps(checks))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         *sys.argv[4:5])
