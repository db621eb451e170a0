"""The port's checkpoint loaders (``cli.load_lm``, ``cli.load_bicodec``)
against what the JAX package's CLI takes.

``load_lm`` takes the keys that ``convert_custom_llama`` reads and no
other, so a reference state dict that also holds the bypassed conformer
(``dnn.conformer.*``) loads and gives the LM of JAX's conversion exactly; a
Lightning checkpoint loads from its "state_dict"; a missing key ends the
command. ``load_bicodec`` reads the reference's ``.safetensors`` file as
JAX's ``_load_bicodec_variables`` does, to the same module as the ``.pt``
file of the same state dict.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_common import (bicodec_variables, jax_sft, port_config,
                               tiny_lm_config, tiny_tokenizer_config)
from unified_audio_tpu.utils.convert import (convert_custom_llama,
                                             export_custom_llama_state_dict)
from unified_audio_tpu.utils.convert_bicodec import export_bicodec_state_dict
from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.models.bicodec import bicodec as t_bicodec
from unified_audio_tpu_torch.models.lm.sft import LLMSFT as TLLMSFT
from unified_audio_tpu_torch.utils import convert as t_convert


def _tensors(sd):
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in
            sd.items()}


@pytest.fixture(scope="module")
def reference_lm():
    """The tiny LM's reference state dict with the "dnn." prefix and the
    conformer's keys beside it, as the reference's checkpoints hold them."""
    cfg = tiny_lm_config()
    _, variables = jax_sft(cfg, seed=7)
    sd = {f"dnn.{k}": v for k, v in export_custom_llama_state_dict(
        jax.device_get(variables), cfg).items()}
    rng = np.random.default_rng(0)
    for k in ("conformer.embed.weight", "conformer.layers.0.ff.w1.weight",
              "conformer.layers.0.ff.w1.bias"):
        sd[f"dnn.{k}"] = rng.standard_normal((4, 3)).astype(np.float32)
    return cfg, _tensors(sd)


def _port_lm(cfg):
    return TLLMSFT(port_config(cfg), num_tasks=3, feats_dim=12)


def _assert_same_as_jax(sft, cfg, sd):
    want = t_convert.llmsft_state_dict(
        convert_custom_llama({k: v.numpy() for k, v in sd.items()}, cfg),
        cfg)
    got = sft.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_lm_with_conformer_keys_loads_as_jax_converts_it(reference_lm,
                                                         tmp_path, capsys):
    cfg, sd = reference_lm
    path = tmp_path / "lm.pt"
    torch.save(sd, path)
    sft = _port_lm(cfg)
    cli.load_lm(sft, path)
    _assert_same_as_jax(sft, cfg, sd)
    err = capsys.readouterr().err
    assert "ignored 3 key(s)" in err and "conformer.* (3)" in err


def test_lm_from_a_lightning_checkpoint(reference_lm, tmp_path):
    """A Lightning checkpoint: the state dict beside the epoch, the step,
    plain hyper-parameters and the optimizer's states, read with
    ``weights_only=True``."""
    cfg, sd = reference_lm
    path = tmp_path / "epoch=3.ckpt"
    torch.save({
        "epoch": 3, "global_step": 1200,
        "pytorch-lightning_version": "2.1.3",
        "hyper_parameters": {"lr": 5e-4, "betas": [0.9, 0.98],
                             "tasks": ("se", "tse"), "name": "unise"},
        "state_dict": sd,
        "optimizer_states": [{
            "state": {0: {"step": torch.tensor(1200.0),
                          "exp_avg": torch.zeros(3)}},
            "param_groups": [{"lr": 5e-4, "params": [0]}]}],
        "lr_schedulers": [{"last_epoch": 1200}],
        "callbacks": {},
    }, path)
    sft = _port_lm(cfg)
    cli.load_lm(sft, path)
    _assert_same_as_jax(sft, cfg, sd)


def test_lm_missing_a_key_fails(reference_lm, tmp_path):
    cfg, sd = reference_lm
    path = tmp_path / "lm.pt"
    torch.save({k: v for k, v in sd.items()
                if k != "dnn.output_head.weight"}, path)
    with pytest.raises(SystemExit) as exit_info:
        cli.load_lm(_port_lm(cfg), path)
    assert "output_head.weight" in str(exit_info.value.code)


@pytest.fixture(scope="module")
def reference_bicodec():
    cfg = tiny_tokenizer_config()
    sd = export_bicodec_state_dict(jax.device_get(bicodec_variables(cfg)),
                                   cfg)
    return t_bicodec.BiCodecConfig(**dataclasses.asdict(cfg)), _tensors(sd)


@pytest.mark.parametrize("tokenize", [True, False])
def test_bicodec_safetensors_equals_pt(reference_bicodec, tmp_path,
                                       tokenize):
    """The same reference state dict as ``.pt`` and as ``.safetensors``
    gives equal modules, the tokenizing BiCodec (training, SPK-SIM) and the
    decoder-only one (``enhance``, ``serve``), and each equals the state
    dict on its own keys."""
    from safetensors.torch import save_file

    cfg, sd = reference_bicodec
    torch.save(sd, tmp_path / "bicodec.pt")
    save_file(sd, str(tmp_path / "bicodec.safetensors"))
    loaded = []
    for name in ("bicodec.pt", "bicodec.safetensors"):
        model = t_bicodec.BiCodec(cfg, tokenize=tokenize)
        cli.load_bicodec(model, tmp_path / name)
        loaded.append(model.state_dict())
    assert set(loaded[0]) == set(loaded[1])
    for k, v in loaded[0].items():
        torch.testing.assert_close(loaded[1][k], v, rtol=0, atol=0)
        if not k.endswith("num_batches_tracked"):  # BatchNorm's counter
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_bicodec_safetensors_without_the_package(reference_bicodec,
                                                 tmp_path, monkeypatch):
    cfg, _ = reference_bicodec
    path = tmp_path / "bicodec.safetensors"
    path.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(SystemExit) as exit_info:
        cli.load_bicodec(t_bicodec.BiCodec(cfg), path)
    assert "'safetensors'" in str(exit_info.value.code)
