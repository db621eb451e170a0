"""The port's utilities (``unified_audio_tpu_torch/utils/token_parser.py``,
``watchdog.py``, ``profiling.py``, ``config.py``) and small public helpers
(``nn/conv.py unpad1d`` and ``conv_transpose1d``, ``RegionAllocator``'s
high water, the quantizers' aliases) against the JAX package's, on the CPU.

The token maps equal JAX's entry for entry and render token strings
alike; the watchdog cases mirror ``tests/test_data.py TestWatchdog``;
``trace`` writes a Chrome trace that names a recorder span and the
ops in it, and ``StepTimer`` summarizes its steps as JAX's does. The
card's half of ``StepTimer`` (it synchronizes the device, so a step's time
covers the kernels it queued) runs in ``chip_smoke.py`` phase 14.
"""
import json
import time

import numpy as np
import pytest
import torch

from unified_audio_tpu.utils import token_parser as j_tp
from unified_audio_tpu_torch.utils import profiling, token_parser, watchdog


@pytest.mark.parametrize("name", ["TASK_TOKEN_MAP", "GENDER_MAP",
                                  "LEVELS_MAP", "EMO_MAP"])
def test_token_maps_equal_jax(name):
    assert getattr(token_parser, name) == getattr(j_tp, name)


def test_token_strings_equal_jax():
    tokens = np.random.default_rng(0).integers(0, 4096, 12)
    for fn in ("global_token_string", "semantic_token_string"):
        assert getattr(token_parser, fn)(tokens) == getattr(j_tp, fn)(tokens)
    assert token_parser.global_token_string([1, 2]) == (
        "<|bicodec_global_1|><|bicodec_global_2|>")


def test_call_with_timeout():
    """Mirrors ``tests/test_data.py TestWatchdog.test_call_with_timeout``:
    a result, a missed deadline, the call's own exception."""
    assert watchdog.call_with_timeout(lambda x: x + 1, 1.0, 41) == 42
    with pytest.raises(watchdog.TimeoutError_):
        watchdog.call_with_timeout(time.sleep, 0.1, 5.0)
    with pytest.raises(ValueError):
        watchdog.call_with_timeout(
            lambda: (_ for _ in ()).throw(ValueError("x")), 1.0)


def test_watchdog_detects_stall():
    """Mirrors ``TestWatchdog.test_watchdog_detects_stall``: no beats for
    longer than the limit fires ``on_stall``."""
    events = []
    with watchdog.Watchdog(on_stall=lambda n, a: events.append(n),
                           poll_interval=0.05) as wd:
        hb = wd.register("producer", limit_seconds=0.1)
        hb.beat()
        time.sleep(0.4)
    assert "producer" in events
    assert wd.stalls["producer"] >= 1


def test_watchdog_quiet_while_beating():
    """A producer that beats inside its limit raises no alarm."""
    events = []
    with watchdog.Watchdog(on_stall=lambda n, a: events.append(n),
                           poll_interval=0.02) as wd:
        hb = wd.register("producer", limit_seconds=1.0)
        for _ in range(20):
            hb.beat()
            time.sleep(0.02)
    assert events == [] and wd.stalls["producer"] == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` on the CPU: one JSON trace under the log directory, with
    the recorder's span (``ua:`` and its name) and the matmul inside it;
    the recorder holds the span."""
    x = torch.randn(64, 64)
    profiling.reset()
    profiling.enable()
    try:
        with profiling.trace(tmp_path / "tb") as prof:
            with profiling.span("decode_step"):
                (x @ x).sum()
        recorded = [s["name"] for s in profiling.export()["spans"]]
    finally:
        profiling.disable()
        profiling.reset()
    files = list((tmp_path / "tb").glob("*.json"))
    assert [str(f) for f in files] == [prof.trace_path]
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert profiling.PREFIX + "decode_step" in names
    assert recorded == ["decode_step"]
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]


def test_step_timer_summary():
    """``StepTimer`` without a device times the host as JAX's does: the
    first step left out, p50/p90 of the rest, each step at least its
    sleep."""
    timer = profiling.StepTimer()
    for s in (0.0, 0.01, 0.02, 0.03):
        with timer:
            time.sleep(s)
    out = timer.summary()
    assert out["steps"] == 3
    assert out["min_s"] >= 0.01 and out["p50_s"] >= 0.02
    assert out["p90_s"] >= out["p50_s"] >= out["min_s"]
    assert out["mean_s"] == pytest.approx(sum(timer.times[1:]) / 3)


def test_step_timer_cpu_device_does_not_sync():
    """A CPU device has no queue to wait for: the timer runs."""
    timer = profiling.StepTimer(device="cpu", skip_first=0)
    with timer:
        pass
    assert timer.summary()["steps"] == 1


# ---------------------------------------------------------------------------
# The small public helpers: configs, unpad1d, conv_transpose1d, the
# allocators' high water, the quantizers' aliases
# ---------------------------------------------------------------------------

def _config_class(name, data):
    """A dataclass with ``data``'s keys, nested dicts as nested classes."""
    import dataclasses

    fields = []
    for key, value in data.items():
        if isinstance(value, dict):
            sub = _config_class(f"{name}_{key}", value)
            fields.append((key, sub, dataclasses.field(default_factory=sub)))
        else:
            fields.append((key, object, None))
    return dataclasses.make_dataclass(name, fields)


@pytest.mark.parametrize("name", ["unise.yaml", "hcodec10.yaml"])
def test_load_config_and_to_dict_match_jax(name, tmp_path):
    """A configs/ file through ``load_config`` and back through
    ``to_dict``: the JAX package's dicts (lists made tuples); an unknown
    key refused by both."""
    from pathlib import Path

    from unified_audio_tpu.utils import config as j_config
    from unified_audio_tpu_torch.utils import config as t_config

    path = Path(__file__).resolve().parents[1] / "configs" / name
    cls = _config_class("Cfg", t_config.load_yaml(path))
    want = j_config.to_dict(j_config.load_config(path, cls))
    got = t_config.to_dict(t_config.load_config(path, cls))
    assert got == want
    if name == "unise.yaml":  # a list made a tuple inside a nested class
        assert got["dataset"]["speech_scp"] == ("./data/speech.scp",)
    bad = tmp_path / "bad.yaml"
    bad.write_text(path.read_text() + "\nnot_a_field: 1\n")
    for module in (j_config, t_config):
        with pytest.raises(ValueError, match="not_a_field"):
            module.load_config(bad, cls)


def test_unpad1d_and_conv_transpose1d_match_jax():
    import jax.numpy as jnp

    from unified_audio_tpu.nn import conv as j_conv
    from unified_audio_tpu_torch.nn import conv as t_conv

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        t_conv.unpad1d(torch.as_tensor(x), (3, 2)).numpy(),
        np.asarray(j_conv.unpad1d(jnp.asarray(x), (3, 2))))
    kernel = rng.standard_normal((5, 6, 4)).astype(np.float32)  # (K, Ci, Co)
    want = np.asarray(j_conv.conv_transpose1d(jnp.asarray(x),
                                              jnp.asarray(kernel), 3))
    got = t_conv.conv_transpose1d(torch.as_tensor(x), torch.as_tensor(
        kernel.transpose(1, 2, 0)), 3).numpy()
    assert got.shape == want.shape == (2, 12 * 3 + 5, 4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_region_allocator_high_water_matches_jax():
    from unified_audio_tpu.serve import paged as j_paged
    from unified_audio_tpu_torch.serve import paged as t_paged

    j, t = j_paged.RegionAllocator(200, 14), t_paged.RegionAllocator(200, 14)
    assert t.high_water() == j.high_water() == 1
    held = [(j.alloc(5), t.alloc(5)) for _ in range(4)]
    j.release(held[3][0])
    t.release(held[3][1])
    assert t.high_water() == j.high_water()
    for bucket in (64, 16):
        assert t.bounded_high_water(bucket) == j.bounded_high_water(bucket)


def test_quantizer_aliases_match_jax():
    """``codebook_size`` of the FSQs, ``ResidualVQ.get_output_from_indices``
    (the reference's name for ``decode``) and FlexiCodec's
    ``DACVectorQuantize.decode_code``."""
    from unified_audio_tpu.ops import quant as j_quant
    from unified_audio_tpu_torch.models.hcodec.flexicodec import \
        DACVectorQuantize
    from unified_audio_tpu_torch.ops import quant as t_quant

    assert t_quant.FSQ((8, 5, 5)).codebook_size == \
        j_quant.FSQ(levels=(8, 5, 5)).codebook_size == 200
    assert t_quant.ResidualFSQ((4, 4, 4), 2, 3).codebook_size == 64
    rvq = t_quant.ResidualVQ(4, 16, 2)
    codes = torch.tensor([[[1, 2], [3, -1]]])
    torch.testing.assert_close(rvq.get_output_from_indices(codes),
                               rvq.decode(codes))
    dvq = DACVectorQuantize(8, 16, 4)
    idx = torch.tensor([[0, 5, 15]])
    torch.testing.assert_close(dvq.decode_code(idx),
                               dvq.codebook.weight[idx])
