"""CodecLM pretraining of the port (``unified_audio_tpu_torch``) against the
JAX package on the CPU, at a tiny configuration: ``CodecLM.pretrain_loss``
(JAX's ``CodecLM.__call__``: offsets, gSOS/sSOS, the final EOS target
dropped, conditioning embeddings in front) with its gradients; eight
``PretrainTrainer`` steps agreeing with JAX's step by step; the token
shards (``write_token_shard``, ``tokenize_corpus`` over the BiCodec
tokenizer) and ``TokenCorpusIterator``'s batches for a seed.

Tolerances: losses within 1e-5 relative (1e-4 over the eight steps),
accuracies and token ids exact, gradients and parameters within 1e-4 of
their largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (jax_tokenizer, port_config, port_tokenizer,
                               random_variables, to_torch)
from unified_audio_tpu.data import token_corpus as j_corpus
from unified_audio_tpu.models.lm.llama import CodecLM as JCodecLM
from unified_audio_tpu.models.lm.llama import LlamaConfig
from unified_audio_tpu.train import optim as j_optim
from unified_audio_tpu.train.pretrain import PretrainTrainer as JTrainer
from unified_audio_tpu_torch.data import token_corpus as t_corpus
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.models.lm import llama as t_llama
from unified_audio_tpu_torch.train import optim as t_optim
from unified_audio_tpu_torch.train.pretrain import PretrainTrainer
from unified_audio_tpu_torch.utils import convert as t_convert

NG, NS = 6, 20  # global and semantic tokens of a tiny batch


def tiny_cfg():
    return LlamaConfig(global_size=16, semantic_size=40, hidden_size=32,
                       num_layers=2, num_heads=4)


def lm_state_dict(params, cfg):
    """CodecLM variables -> the port's ``CodecLM`` state dict."""
    return t_convert.llmsft_state_dict(
        {"params": {"lm": jax.device_get(params)["params"]}}, cfg)


def port_lm(params, cfg):
    m = t_llama.CodecLM(port_config(cfg))
    m.load_state_dict(to_torch(lm_state_dict(params, cfg)))
    return m


def ids(cfg, seed, b=3, ng=NG, ns=NS):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.global_size, (b, ng)).astype(np.int32),
            rng.integers(0, cfg.semantic_size, (b, ns)).astype(np.int32))


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
def test_pretrain_loss_and_gradients(cond):
    """``pretrain_loss`` (and with 4 conditioning embeddings in front): the
    loss within 1e-5 relative, the accuracy exact, every gradient (the
    conditioning embeddings' too) within 1e-4 of its largest entry."""
    cfg = tiny_cfg()
    g, s = ids(cfg, 1)
    c = (np.random.default_rng(2).standard_normal(
        (3, 4, cfg.hidden_size)).astype(np.float32) if cond else None)
    jm = JCodecLM(cfg)
    params = random_variables(jm, g, s, seed=3)

    def f(p, c):
        return jm.apply(p, g, s, cond_embeds=c)

    if cond:
        (loss, acc), (grads, c_grad) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, c)
    else:
        (loss, acc), grads = jax.value_and_grad(f, has_aux=True)(params,
                                                                 None)
    port = port_lm(params, cfg)
    ct = torch.as_tensor(c).requires_grad_(True) if cond else None
    got, got_acc = port.pretrain_loss(torch.as_tensor(g), torch.as_tensor(s),
                                      ct)
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    assert got_acc.item() == float(acc)
    want = lm_state_dict(grads, cfg)
    for k, p in port.named_parameters():
        w = np.asarray(want[k])
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    if cond:
        w = np.asarray(c_grad)
        assert np.abs(ct.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_pretrain_targets_drop_the_final_eos():
    """The targets are [g + 3, sSOS, s + offset] and the inputs [gSOS, g +
    3, sSOS, s + offset] without its last: the sequence length is Ng + T +
    1 and no target is the semantic EOS."""
    cfg = port_config(tiny_cfg())
    m = t_llama.CodecLM(cfg)
    seen = {}

    def forward_embeds(embeds, target_ids):
        seen["embeds"], seen["targets"] = embeds, target_ids
        return torch.zeros(()), torch.zeros(())

    m.forward_embeds = forward_embeds
    g, s = (torch.as_tensor(x) for x in ids(tiny_cfg(), 4, b=2))
    m.pretrain_loss(g, s)
    t = seen["targets"]
    assert t.shape == (2, NG + NS + 1)
    assert (t[:, :NG] == g + cfg.global_offset).all()
    assert (t[:, NG] == cfg.semantic_sos).all()
    assert (t[:, NG + 1:] == s + cfg.semantic_offset).all()
    assert not (t == cfg.semantic_eos).any()
    assert seen["embeds"].shape == (2, NG + NS + 1, cfg.hidden_size)


def test_pretrain_trainer_eight_steps():
    """Eight ``PretrainTrainer`` steps of the port and of JAX from the same
    weights and batches (a 2-step warmup to the 5e-4 peak): loss and
    accuracy step by step (losses within 1e-4 relative, accuracies within
    one token of the batch), and the parameters after the steps within
    1e-4 of their largest entry."""
    cfg = tiny_cfg()
    g0, s0 = ids(cfg, 5)
    jt = JTrainer(cfg, jax.random.PRNGKey(0), optimizer=j_optim.make_optimizer(
        warmup_steps=2), example=(jnp.asarray(g0), jnp.asarray(s0)))
    model = port_lm(jt.params, cfg)
    tt = PretrainTrainer(port_config(cfg), model, t_optim.Optimizer(
        model.parameters(), warmup_steps=2), device="cpu")
    got, want = [], []
    for i in range(8):
        g, s = ids(cfg, 10 + i)
        want.append(jt.train_step(jnp.asarray(g), jnp.asarray(s)))
        got.append(tt.train_step(g, s))
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4, atol=0)
    assert np.abs(got[:, 1] - want[:, 1]).max() <= 1.0 / (3 * (NG + NS + 1))
    assert tt.step == jt.step == 8
    sd = lm_state_dict(jt.params, cfg)
    for k, p in model.named_parameters():
        w = np.asarray(sd[k])
        assert np.abs(p.detach().numpy() - w).max() <= 1e-4 * np.abs(
            w).max(), k


def test_pretrain_trainer_fit_and_device(monkeypatch, capsys):
    """``fit`` trains until ``max_steps`` and logs every ``log_every``
    steps; without a card the trainer refuses to build unless given
    ``device="cpu"``."""
    cfg = port_config(tiny_cfg())
    tt = PretrainTrainer(cfg, device="cpu", seed=1)
    batches = iter([ids(tiny_cfg(), 20 + i) for i in range(5)])
    tt.fit(batches, max_steps=4, log_every=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert tt.step == 4 and len(lines) == 2 and '"step": 4' in lines[-1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PretrainTrainer(cfg)


# ---------------------------------------------------------------------------
# Token shards and batches
# ---------------------------------------------------------------------------

def _utterances(seed, n, ng=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 16, ng), rng.integers(0, 40, rng.integers(5, 15)))
            for _ in range(n)]


def test_token_shards_and_batches(tmp_path):
    """The port's shards are the JAX package's (each one read by the other's
    loader), and ``TokenCorpusIterator`` gives JAX's batches for the same
    seed: random crops of long utterances, wrap-padding of short ones, the
    shard order and shuffles of several epochs, the split over
    processes."""
    for k in range(3):
        t_corpus.write_token_shard(tmp_path / f"tokens_{k:05d}.npz",
                                   _utterances(k, 7))
    paths = sorted(tmp_path.glob("*.npz"))
    for p in paths:
        for (ga, sa), (gb, sb) in zip(t_corpus._load_shard(p),
                                      j_corpus._load_shard(p)):
            np.testing.assert_array_equal(ga, gb)
            np.testing.assert_array_equal(sa, sb)
    for rank, count in ((0, 1), (1, 2)):
        kw = dict(batch_size=3, semantic_len=10, seed=7, process_index=rank,
                  process_count=count)
        jit_, tit = iter(j_corpus.TokenCorpusIterator(paths, **kw)), iter(
            t_corpus.TokenCorpusIterator(paths, **kw))
        for _ in range(8):  # past an epoch
            (jg, js, jc), (tg, ts, tc) = next(jit_), next(tit)
            assert jc is None and tc is None
            assert tg.dtype == ts.dtype == np.int32 and ts.shape == (3, 10)
            np.testing.assert_array_equal(tg, jg)
            np.testing.assert_array_equal(ts, js)


def test_iterator_raises_without_a_whole_batch(tmp_path):
    """Shards of fewer utterances than a batch give no batch: the port's
    iterator raises in the consumer (the JAX package's loops forever)."""
    t_corpus.write_token_shard(tmp_path / "tokens_00000.npz",
                               _utterances(0, 3))
    it = iter(t_corpus.TokenCorpusIterator([tmp_path / "tokens_00000.npz"],
                                           batch_size=4, semantic_len=8))
    with pytest.raises(ValueError, match="no shard holds 4"):
        next(it)


def test_tokenize_corpus_over_bicodec(tmp_path):
    """``tokenize_corpus`` over the port's BiCodec tokenizer (the tiny
    XLSR stack) writes the shards the JAX package's writes from the same
    wavs: global and semantic tokens equal, 2 utterances a shard."""
    jtok = jax_tokenizer()
    ttok = port_tokenizer(jtok)
    rng = np.random.default_rng(9)
    wavs = []
    for i, n in enumerate((4800, 6400, 5600)):
        path = tmp_path / f"u{i}.wav"
        write_wav(path, (0.3 * rng.standard_normal(n)).astype(np.float32),
                  16000)
        wavs.append(path)
    got = t_corpus.tokenize_corpus(ttok, wavs, tmp_path / "port",
                                   utterances_per_shard=2)
    want = j_corpus.tokenize_corpus(jtok, wavs, tmp_path / "jax",
                                    utterances_per_shard=2)
    assert [p.name for p in got] == [p.name for p in want] == [
        "tokens_00000.npz", "tokens_00001.npz"]
    for a, b in zip(got, want):
        ua, ub = t_corpus._load_shard(a), j_corpus._load_shard(b)
        assert len(ua) == len(ub)
        for (ga, sa), (gb, sb) in zip(ua, ub):
            assert ga.shape == (dataclasses.asdict(jtok.config)[
                "token_num"],)
            np.testing.assert_array_equal(ga, gb)
            np.testing.assert_array_equal(sa, sb)
