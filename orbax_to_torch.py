"""Convert an orbax LM checkpoint of the JAX package into a torch file the
PyTorch port loads.

    python orbax_to_torch.py CKPT_DIR OUT.pt [--step N]

``CKPT_DIR`` is a directory that ``unified_audio_tpu/train/checkpoint.py
CheckpointManager`` wrote (``cli train-unise`` of the JAX package saves
the LM's variables there as "params"); the latest step is read unless
``--step`` names one. The variables go through the port's numpy bridge
(``unified_audio_tpu_torch/utils/convert.py llmsft_state_dict``) into the
reference LM layout and are written as ``{"state_dict": ...}``, which
``python -m unified_audio_tpu_torch.cli serve|enhance|eval|train-unise
--ckpt OUT.pt`` loads.

This script runs where JAX and orbax are installed, never on the card: it
is the one script of the repository beside the port that imports them.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def restore_variables(ckpt_dir, step=None):
    """-> (step, the LM's variables) of the orbax checkpoint in
    ``ckpt_dir``, restored as the JAX CLI's ``_load_sft_checkpoint``
    restores them."""
    import jax

    from unified_audio_tpu.train.checkpoint import CheckpointManager

    path = Path(ckpt_dir)
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint directory at {ckpt_dir}")
    mgr = CheckpointManager(path)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint steps inside {ckpt_dir}")
    if step not in mgr.manager.all_steps():
        raise FileNotFoundError(f"no step {step} inside {ckpt_dir} (steps: "
                                f"{sorted(mgr.manager.all_steps())})")
    restored = mgr.restore(step)
    params = restored["params"] if "params" in restored else restored
    return step, jax.device_get(params)


def lm_shape(variables):
    """The widths ``llmsft_state_dict`` reads, taken from the arrays: the
    hidden size from the codec embedding, the layer count from the
    stacked layers' leading axis."""
    lm = variables["params"]["lm"]
    layers = lm["backbone"]["layers"]
    return SimpleNamespace(
        hidden_size=np.shape(lm["codec_embedding"]["embedding"])[1],
        num_layers=np.shape(layers["input_layernorm"]["weight"])[0])


def convert(ckpt_dir, out, step=None):
    """Write the LM of ``ckpt_dir`` (its latest step, or ``step``) to
    ``out`` as ``{"state_dict": ...}`` -> (step, number of tensors)."""
    import torch

    from unified_audio_tpu_torch.utils.convert import llmsft_state_dict

    step, variables = restore_variables(ckpt_dir, step)
    sd = llmsft_state_dict(variables, lm_shape(variables))
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, out)
    return step, len(sd)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt_dir", help="orbax CheckpointManager directory")
    ap.add_argument("out", help="the torch file to write")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to convert (default: the latest)")
    args = ap.parse_args(argv)
    try:
        step, n = convert(args.ckpt_dir, args.out, args.step)
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
    print(f"wrote {n} tensors of step {step} to {args.out}")


if __name__ == "__main__":
    main()
