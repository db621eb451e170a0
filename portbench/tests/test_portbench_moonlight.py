"""The ``unise-moonlight-serve-c96-s64`` cell: on the CPU at tiny sizes
(the Moonlight stack at hidden 64, 3 layers, 8 experts top-2; the unise
cell's tiny WavLM, BiCodec and traffic), a sound run is correct and each
fault the cell can have makes it not correct: a routed expert's output
dropped, a latent row left unwritten by the decode step, a served token
altered. On the card at the cell's own size (``requires_cuda``), the
program's compared numbers and the fp8 control's, seed by seed, from which
the cell's limits were set:

    python -m pytest portbench/tests/test_portbench_moonlight.py -q -s
"""
import copy
from argparse import Namespace

import pytest
import torch

from portbench.harness import manifest
from portbench.tests import tiny

CELL = "unise-moonlight-serve-c96-s64"
TINY = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
            v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=2, vocab_size=160)
# the cell's mean gaps held to limits of the tiny stack's own scale: there
# a sound bf16 run reads under 2e-4 (3 layers of 8 experts: no routing
# chaos) and a fault moves the mean by 0.015-0.2, less than the cell's 26
# MoE layers would
TINY_LIMITS = dict(logit_gap_mean=0.005, support_gap_mean=0.0005)


def tiny_run(seed=21):
    """A ``Run`` of the cell on the CPU: the configuration's published keys
    cut to ``TINY``, the unise cell's tiny sections and traffic."""
    from portbench.harness.context import Run

    bench = manifest.load_manifest()
    entry = manifest.entry(bench["workloads"], CELL, "workload")
    cfg = manifest.config_params(bench, entry["config"])
    small = tiny.config("unise")
    cfg.update(TINY, codec_vocab={"global_size": 64, "semantic_size": 64},
               wavlm=small["wavlm"], bicodec=small["bicodec"],
               unise=small["unise"])
    cell = copy.deepcopy(tiny.cell("unise-serve-c96-s64"))
    cell.update(driver="unise_moonlight_serve", config=entry["config"],
                check=dict(manifest.cell_params(CELL)["check"],
                           min_tokens=cell["check"]["min_tokens"],
                           **TINY_LIMITS))
    ref = manifest.load_module(manifest.reference_path(entry["config"]),
                               "reference." + entry["config"])
    return Run(torch, Namespace(seed=seed, seconds=0.0, trace=0), cell, cfg,
               entry, ref, device="cpu")


def correct(seed=21):
    run = tiny_run(seed)
    drv = manifest.load_module(manifest.driver_path(run.cell["driver"]),
                               "drivers." + run.cell["driver"])
    st = drv.setup(run)
    out = drv.window(run, st)
    drv.release(run, st)
    checks = drv.check(run, st, out)
    return all(c["value"] <= c["limit"] for c in checks), checks


def expert_dropped(mp):
    """Each token's first routed expert adds nothing: its weight is zeroed
    once the router has chosen."""
    from unified_audio_tpu_torch.nn import transformer
    real = transformer.MoE.route

    def route(self, x):
        top, w = real(self, x)
        return top, torch.cat([torch.zeros_like(w[..., :1]), w[..., 1:]], -1)
    mp.setattr(transformer.MoE, "route", route)


def latent_row_unwritten(mp):
    """The decode step attends without writing its new latent rows."""
    from unified_audio_tpu_torch.models.lm import moonlight

    def paged(self, x, cos, sin, layer_rows, blk, off, gather, mask):
        x = x.to(self.q_proj.weight.dtype)
        q_nope, q_pe = self.queries(x, cos, sin)
        rows = layer_rows.view(-1, layer_rows.shape[-1])[gather]
        return self.o_proj(self.absorbed(q_nope, q_pe, rows, mask).to(
            x.dtype))
    mp.setattr(moonlight.LatentAttention, "paged", paged)


def token_altered(mp):
    from portbench.tests.test_portbench_faults import serve_token_altered
    serve_token_altered(mp)


def test_sound_run_is_correct():
    ok, checks = correct()
    assert ok, checks


@pytest.mark.parametrize("fault", [expert_dropped, latent_row_unwritten,
                                   token_altered])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = correct()
    assert not ok, checks


@pytest.mark.requires_cuda
def test_control_fails_where_program_passes(monkeypatch):
    """At the cell's size on the card, a 12-s window a seed: the program's
    readings under the limits, the fp8 control's over at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from portbench.tests import test_portbench_controls as controls

    monkeypatch.setitem(controls.WINDOW_S, CELL, 12.0)
    got = controls._runs(torch, CELL, {"program": (None, True)})
    wrong = [g for g in got if controls._correct(g[2]) != (g[1] == "program")]
    assert not wrong, wrong
