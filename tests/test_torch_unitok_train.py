"""UniTok's teacher-forced training loss in the port
(``unified_audio_tpu_torch``) against the JAX package on the CPU:
``UniTokLM.loss`` (JAX's ``UniTokLM.__call__``: the delay pattern, BOS and
EOS, the prompt, the masked per-codebook NLL and accuracy averaged over
the codebooks) with its gradients, and ``UniTokPipeline.train_loss`` over
the tiny HCodec-1.0 tokenizer of ``tests/test_torch_hcodec.py`` (the
target's codes, the input's and reference's HuBERT features).

Tolerances: losses within 1e-5 relative (the pipeline's 1e-4), accuracies
within 1e-6, gradients within 1e-4 of their largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import random_variables
from test_torch_hcodec import L, _wav, seeded_models, small10
from test_torch_unitok import port_unitok
from test_torch_unitok import tiny_cfg as unitok_cfg
from unified_audio_tpu.models.unitok.model import UniTokConfig, UniTokLM
from unified_audio_tpu.models.unitok.pipeline import (
    UniTokPipeline as JPipeline)
from unified_audio_tpu_torch.models.unitok.model import UNITOK_TASKS
from unified_audio_tpu_torch.models.unitok.pipeline import UniTokPipeline
from unified_audio_tpu_torch.utils.convert import unitok_state_dict


def grads_close(port, want, cfg, tol=1e-4):
    want = unitok_state_dict(jax.device_get(want), cfg)
    for k, p in port.named_parameters():
        w = np.asarray(want[k])
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), k


# (task, caption frames, reference frames, input frames)
CASES = [(4, 3, None, 5), (1, None, 4, 6), (5, None, None, 7)]


@pytest.mark.parametrize("case", CASES, ids=["lass", "tse", "codec"])
def test_unitok_loss_and_gradients(case):
    """``UniTokLM.loss`` on 2 rows of 6 frames with a caption, a reference
    or the input alone: loss and accuracy as JAX's, every gradient (the
    task table, the separators, both adapters, the K code tables and
    heads, the backbone) within 1e-4 of its largest entry."""
    task, nc, nr, ni = case
    cfg = unitok_cfg()
    rng = np.random.default_rng(task)

    def feats(n, dim):
        return None if n is None else rng.standard_normal(
            (2, n, dim)).astype(np.float32)

    cap, ref, inp = feats(nc, cfg.text_dim), feats(nr, cfg.audio_dim), \
        feats(ni, cfg.audio_dim)
    codes = rng.integers(0, cfg.codebook_size,
                         (2, 6, cfg.num_codebooks)).astype(np.int32)
    jlm = UniTokLM(cfg)
    variables = jax.device_get(random_variables(
        jlm, 0, np.zeros((1, 3, cfg.text_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 6, cfg.num_codebooks), np.int32), seed=5))
    (loss, acc), grads = jax.value_and_grad(
        lambda v: jlm.apply(v, task, cap, ref, inp, codes),
        has_aux=True)(variables)
    port = port_unitok(cfg, variables).train()

    def t(x):
        return None if x is None else torch.as_tensor(x)

    got, got_acc = port.loss(task, t(cap), t(ref), t(inp), t(codes))
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    assert abs(got_acc.item() - float(acc)) <= 1e-6
    grads_close(port, grads, cfg)


@pytest.fixture(scope="module")
def pipes():
    """The JAX and the port's ``UniTokPipeline`` over the tiny HCodec-1.0
    tokenizer and a tiny UniTok LM over its 2 x 2 codebooks of 32."""
    cfg, ssl_cfg, _, _, jtok, tok = seeded_models(small10(), L)
    ucfg = UniTokConfig(codebook_size=cfg.codebook_size,
                        num_quantizers=cfg.num_quantizers, hidden_size=32,
                        num_layers=2, num_heads=4, text_dim=8,
                        audio_dim=ssl_cfg.hidden_size, max_positions=256)
    jlm = UniTokLM(ucfg)
    lm_vars = jax.device_get(random_variables(
        jlm, 0, np.zeros((1, 2, ucfg.text_dim), np.float32), None,
        np.zeros((1, 4, ucfg.audio_dim), np.float32),
        np.zeros((1, 4, ucfg.num_codebooks), np.int32), seed=9))
    return (ucfg, lm_vars, JPipeline(jtok, jlm, lm_vars),
            UniTokPipeline(tok, port_unitok(ucfg, lm_vars).train()))


@pytest.mark.parametrize("task", ["codec", "tse", "lass"])
def test_pipeline_train_loss(pipes, task):
    """``train_loss`` on 2 clips: "codec" from the input alone, "tse" with
    a reference wav, "lass" with caption features; the loss within 1e-4
    relative, the accuracy within 1e-6, the LM's gradients within 1e-4 of
    their largest entry (the tokenizer stays frozen)."""
    ucfg, lm_vars, jpipe, pipe = pipes
    inp = np.concatenate([_wav(40, L), _wav(41, L)])
    tgt = np.concatenate([_wav(42, L), _wav(43, L)])
    ref = (np.concatenate([_wav(44, 640 * 3), _wav(45, 640 * 3)])
           if task == "tse" else None)
    cap = (np.random.default_rng(46).standard_normal(
        (2, 3, ucfg.text_dim)).astype(np.float32) if task == "lass"
        else None)
    (loss, acc), grads = jax.value_and_grad(
        lambda v: jpipe.train_loss(v, task, jnp.asarray(inp),
                                   jnp.asarray(tgt), cap,
                                   None if ref is None else jnp.asarray(ref)),
        has_aux=True)(lm_vars)
    pipe.lm.zero_grad(set_to_none=True)
    got, got_acc = pipe.train_loss(
        task, inp, tgt, None if cap is None else torch.as_tensor(cap), ref)
    got.backward()
    assert UNITOK_TASKS[task] in range(ucfg.num_tasks)
    assert abs(got.item() - float(loss)) <= 1e-4 * abs(float(loss))
    assert abs(got_acc.item() - float(acc)) <= 1e-6
    grads_close(pipe.lm, grads, ucfg)
    assert not any(p.requires_grad and p.grad is not None
                   for p in pipe.tokenizer.codec.parameters())
