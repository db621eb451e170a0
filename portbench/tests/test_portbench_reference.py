"""Each reference against the port at tiny sizes on the CPU, on the
benchmark's own weights handed to both."""
import numpy as np
import pytest
import torch

from portbench.harness import manifest, weights
from portbench.tests import tiny


def _driver(cell):
    params = tiny.cell(cell)
    return manifest.load_module(manifest.driver_path(params["driver"]),
                                "drivers." + params["driver"])


def test_unise_reference_matches_port():
    run = tiny.run("unise-serve-c96-s64", seed=11)
    run.config["dtypes"]["lm_served"] = "float32"  # the LM unrounded
    drv = _driver("unise-serve-c96-s64")
    p = drv._port()
    ref, unise = drv.build(run, p)
    g = torch.Generator().manual_seed(0)
    wav = (torch.rand(2, 6400, generator=g) - 0.5)
    with torch.no_grad():
        np.testing.assert_allclose(ref.features(wav), unise.wavlm_feats(wav),
                                   rtol=1e-5, atol=1e-5)
        feats = ref.features(wav)
        gi = torch.randint(0, 64, (4,), generator=g)
        si = torch.randint(0, 64, (20,), generator=g)
        gl, sl = ref.code_logits(1, wav[0], wav[1], gi, si)
        # the port's teacher-forced logits over the same sequence
        cfg = unise.sft.cfg
        ids = torch.cat([torch.tensor([cfg.global_sos]),
                         gi + cfg.global_offset,
                         torch.tensor([cfg.semantic_sos]),
                         si[:-1] + cfg.semantic_offset])
        prompt = unise.sft.prompt(1, feats[1:2], feats[0:1])
        emb = torch.cat([prompt, unise.sft.embed_codes(ids)[None]], 1)
        out = unise.sft.head(unise.sft.backbone(emb))[0, prompt.shape[1]:]
        np.testing.assert_allclose(gl, out[:4], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(sl, out[5:], rtol=1e-4, atol=1e-4)
        w_ref = ref.detokenize(gi[None], si[None])
        w_port = unise.tokenizer.detokenize(gi[None, None], si[None])
        np.testing.assert_allclose(w_ref, w_port, rtol=1e-5, atol=1e-6)


def test_unise_gaps_read_served_codes():
    lm = {"global_size": 3, "semantic_size": 2}
    gl = torch.tensor([[0, 0, 0, 1.0, 2.0, 0.5, 9, 9]])
    sl = torch.tensor([[9, 9, 9, 9, 9, 9, 0.0, 3.0]])
    g = tiny_gaps(gl, sl, [1], [1], lm)
    assert g.tolist() == [0.0, 0.0]
    g = tiny_gaps(gl, sl, [2], [0], lm)
    assert g.tolist() == [1.5, 3.0]
    assert tiny_gaps(gl, sl, [3], [0], lm)[0] == float("inf")
    # the control's reading: the codes that other logits put first
    pick = (torch.tensor([[0, 0, 0, 0, 0, 5.0, 0, 0]]),
            torch.tensor([[0, 0, 0, 0, 0, 0, 5.0, 0]]))
    assert tiny_gaps(gl, sl, [1], [1], lm, pick).tolist() == [1.5, 3.0]


def tiny_gaps(gl, sl, g, s, lm, pick=None):
    from portbench.reference import unise
    return unise.gaps(gl, sl, torch.tensor(g), torch.tensor(s), lm, pick)


@pytest.mark.parametrize("top_k,top_p", [(50, 0.95), (5, 0.5), (64, 1.0)])
def test_unise_support_matches_port_filter(top_k, top_p):
    """The reference's sampling support is the port's top-k/top-p filter."""
    from portbench.reference import unise
    from unified_audio_tpu_torch.models.lm.llama import (NEG_INF,
                                                         filter_logits_vec)
    x = torch.randn(200, 64, generator=torch.Generator().manual_seed(4)) * 2
    kept = filter_logits_vec(x, torch.full((200,), top_k),
                             torch.full((200,), top_p)) > NEG_INF
    least = unise._least_kept(x, top_k, top_p)
    assert torch.equal(kept, x >= least[:, None])


def test_unise_support_gaps_read_served_codes():
    lm = {"global_size": 3, "semantic_size": 3}
    gl = torch.tensor([[9, 9, 9, 4.0, 3.0, 0.0, 9, 9, 9]])
    sl = torch.tensor([[9, 9, 9, 9, 9, 9, 1.0, 1.0, -2.0]])
    sup = lambda g, s, pick=None: tiny_support(gl, sl, g, s, lm, pick)
    # top 2 of each range; softmax(4, 3) puts 0.73 on the first code
    assert sup([1], [1]).tolist() == [0.0, 0.0]
    assert sup([2], [2], None).tolist() == [3.0, 3.0]
    assert tiny_support(gl, sl, [1], [0], lm, None, top_p=0.5).tolist() == [
        1.0, 0.0]
    assert sup([3], [0])[0] == float("inf")
    # the control's reading: codes drawn from other logits' own support
    alt = torch.tensor([[0, 0, 0, -50.0, -50.0, 50.0, 0, 0, 0]])
    alt_s = torch.tensor([[0, 0, 0, 0, 0, 0, -50.0, -50.0, 50.0]])
    g = torch.Generator().manual_seed(0)
    assert sup([0], [0], (alt, alt_s, 0.8, g)).tolist() == [3.0, 3.0]


def tiny_support(gl, sl, g, s, lm, pick, top_k=2, top_p=0.95):
    from portbench.reference import unise
    return unise.support_gaps(gl, sl, torch.tensor(g), torch.tensor(s), lm,
                              top_k, top_p, pick)


def test_training_schedule_resumes_through_the_optimizer():
    """The cell's schedule start reaches the port's optimizer through its
    own resume path: the first update runs at the schedule's rate there."""
    from portbench.drivers import unise_train
    from unified_audio_tpu_torch.train.optim import Optimizer
    opt_cfg = tiny.cell("unise-train-sft-b32x5s")["opt"]
    lin = torch.nn.Linear(3, 2)
    opt = Optimizer(lin.parameters(), **opt_cfg)
    unise_train.resume_schedule(opt, 2000)
    for k in range(3):
        assert opt.lr == unise_train.schedule(opt_cfg, 2000 + k)
        lin(torch.ones(1, 3)).sum().backward()
        opt.step()


def test_norm_gap_reads_the_worst_counted_leaf():
    from portbench.drivers.unise_train import norm_gap
    ref = {"a": torch.ones(4), "b": torch.ones(4) * 2, "c": torch.ones(4)}
    got = {"a": torch.ones(4) * 1.5, "b": torch.ones(4) * 2,
           "c": torch.zeros(4)}
    # over the larger of the leaf's norm (2) and the median leaf's (2)
    assert norm_gap(ref, got, {"a", "b"}) == pytest.approx(0.5)
    assert norm_gap(ref, got, {"a", "b", "c"}) == pytest.approx(1.0)
    assert norm_gap(ref, got, set()) == 0.0


def test_hcodec10_reference_matches_port():
    run = tiny.run("hcodec10-roundtrip-b16x10s", seed=5)
    drv = _driver("hcodec10-roundtrip-b16x10s")
    st = drv.setup(run)
    x = st.bank[0]
    with torch.no_grad():
        a, s = st.tok.tokenize(x)
        ra, rs = st.ref.tokenize(x)
        assert torch.equal(a, ra) and torch.equal(s, rs)
        assert len(set(a[:, 0].flatten().tolist())) > 1
        np.testing.assert_allclose(st.ref.detokenize(a, s),
                                   st.tok.detokenize(a, s),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", ["UniSEReference", "HCodec10Reference"])
def test_weights_hand_over_strictly(cls):
    from portbench.reference import hcodec10, unise
    mod = unise if cls == "UniSEReference" else hcodec10
    name = "unise" if cls == "UniSEReference" else "hcodec10"
    a = getattr(mod, cls)(tiny.config(name))
    b = getattr(mod, cls)(tiny.config(name))
    weights.fill_(torch, a, torch.Generator().manual_seed(3))
    weights.fill_(torch, b, torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    weights.hand_over(a, b)
