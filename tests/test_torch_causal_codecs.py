"""The causal HCodec-1.5 and FlexiCodec of the port
(``unified_audio_tpu_torch``) against the JAX package on the CPU, at tiny
sizes: a causal base config (``base.causal``) builds the causal SEANet
encoder and decoder in ``AdaptiveHCodec``, as in JAX (the port once
ignored it); ``is_causal`` pads FlexiCodec's ConvNeXt adapters on the
left. Codes exact, waveforms within 1e-4 of their peak.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_adaptive import (_inputs as adaptive_inputs, _sims,
                                 margin, mid_threshold)
from test_torch_adaptive import seeded_models as seeded_adaptive
from test_torch_adaptive import tiny_cfg as adaptive_cfg
from test_torch_flexicodec import _inputs as flexi_inputs
from test_torch_flexicodec import _peak_close, _seeded as seeded_flexi
from test_torch_flexicodec import T as FLEXI_T, aligned_cfg
from test_torch_flexicodec import tiny_cfg as flexi_cfg
from test_torch_hcodec import small10


def test_causal_adaptive_equals_jax():
    """A tiny causal HCodec-1.5 (``base.causal``): the port builds the
    causal SEANet encoder and decoder, as JAX does; its group codes equal
    JAX's and its waveform is within 1e-4 of JAX's peak."""
    base = dataclasses.replace(small10(), feat_dim=16, causal=True)
    cfg, variables, jm, port = seeded_adaptive(adaptive_cfg(base=base))
    assert port.encoder.model[0].causal and \
        port.decoder.prior_net[1].conv1.pads == (2, 0)
    wav, feat = adaptive_inputs(5)
    sem = jm.apply(variables, feat,
                   method=lambda m, f: m.semantic_encoder(f))
    thr = mid_threshold(_sims(sem))
    ja, js = jm.apply(variables, wav, feat, method="encode", threshold=thr)
    with torch.no_grad():
        ta, ts = port.encode(torch.as_tensor(wav), torch.as_tensor(feat),
                             threshold=thr)
    msg = f"min |sim - thr| {margin(_sims(sem), thr):.3e}"
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=msg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=msg)
    want = np.asarray(jm.apply(variables, ja, js, method="decode"))
    with torch.no_grad():
        got = port.decode(ta, ts).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("aligned", [False, True], ids=["dual", "aligned"])
def test_causal_flexicodec(aligned):
    """``is_causal``: the adapters' ConvNeXt blocks pad (6, 0); codes equal
    JAX's and the waveform within 1e-4 of its peak, in the DualCodec mode
    and the aligned mode (at a threshold between the two middle
    similarities of the downsampled semantic frames)."""
    cfg = (aligned_cfg if aligned else flexi_cfg)(is_causal=True)
    cfg, variables, jm, port = seeded_flexi(cfg, 3)
    assert port.convnext_encoder[1].causal_pad == 6
    wav, sem = flexi_inputs(13)
    sims = _sims(np.asarray(sem).reshape(1, FLEXI_T, 2, -1).mean(2))
    kw = dict(threshold=mid_threshold(sims)) if aligned else {}
    ja, js = jm.apply(variables, wav, sem, method="encode", **kw)
    with torch.no_grad():
        ta, ts = port.encode(torch.as_tensor(wav), torch.as_tensor(sem),
                             **kw)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if aligned:
        assert 1 < int((ta.numpy()[0, :, 0] >= 0).sum()) < FLEXI_T
    with torch.no_grad():
        rec = port.decode(ta, ts).numpy()
    _peak_close(rec, jm.apply(variables, ja, js, method="decode"))
