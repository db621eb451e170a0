"""Port vs JAX: UniSE's training data pipeline and its utilities.

* each simulation function, and ``simulate_data`` for every mode with and
  without each input, bit-equal to the JAX package's under the same
  ``np.random.Generator`` seed;
* ``TrainDataIterator`` batches bit-equal to the JAX package's with one
  worker (with more, the shared draws depend on thread timing in both);
* a wav that fails to load raises in the consumer within a timeout
  (the JAX iterator waits forever);
* the ``Prefetcher``'s order, content, pass-through fields and error
  passing, and that a consumer that stops early stops its producer;
* ``load_yaml`` equal to ``yaml.safe_load`` on every ``configs/*.yaml``,
  ``from_dict``, and ``MetricsLogger``.
"""
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from unified_audio_tpu.data import data_module as j_dm
from unified_audio_tpu.data import simulation as j_sim
from unified_audio_tpu_torch.data import data_module as t_dm
from unified_audio_tpu_torch.data import simulation as t_sim
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.utils import config as t_config
from unified_audio_tpu_torch.utils.logging import MetricsLogger

REPO = Path(__file__).resolve().parents[1]


def _sig(seed, n=16000, c=1, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal((c, n))
            ).astype(np.float32)


def _rir(n=2000):
    h = np.zeros((1, n), np.float32)
    h[0, [5, 300, 900]] = [1.0, 0.5, 0.2]
    return h


def _both(fn_name, *args, seed=None, **kw):
    """(port result, JAX result) of simulation.<fn_name>; a ``seed`` gives
    each side its own Generator of that seed."""
    out = []
    for mod in (t_sim, j_sim):
        extra = {"rng": np.random.default_rng(seed)} if seed is not None \
            else {}
        out.append(getattr(mod, fn_name)(*args, **kw, **extra))
    return out


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", [
    ("detect_non_silence", (_sig(1),), {}),
    ("detect_non_silence", (_sig(1, n=500),), {}),
    ("add_reverberation", (_sig(2), _rir()), {}),
    ("estimate_early_rir", (_rir(),), {}),
    ("bandwidth_limitation", (_sig(3), 16000, 4000), {}),
    ("clipping", (_sig(4), 0.05, 0.95), {}),
    ("apply_packet_loss", (_sig(5), 16000, [1, 4, 9], 20), {}),
], ids=lambda c: c[0])
def test_simulation_functions(case):
    name, args, kw = case
    _equal(*_both(name, *args, **kw))


@pytest.mark.parametrize("noise_len", [8000, 16000, 24000])
def test_mix_noise(noise_len):
    _equal(*_both("mix_noise", _sig(6), _sig(7, n=noise_len), 3.0, seed=11))


def test_packet_loss_indices():
    _equal(*_both("packet_loss_indices", 80000, 16000, 20, 0.2, 5, seed=12))


@pytest.mark.parametrize("mode", ["se", "tse", "rtse"])
@pytest.mark.parametrize("inputs", ["all", "no_interf", "no_noise_rir"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_data(mode, inputs, seed):
    speech = _sig(20 + seed, n=24000)
    interf = None if inputs == "no_interf" else _sig(30 + seed, n=20000)
    noise = None if inputs == "no_noise_rir" else _sig(40, n=12000, scale=0.1)
    rir = None if inputs == "no_noise_rir" else _rir()
    cfg = dict(j_sim.DEFAULT_SIM_CONFIG,
               reverberation={"prob": 0.7}, noise={"prob": 0.9,
                                                   "snr": [-5.0, 20.0]})
    _equal(*_both("simulate_data", mode, speech, interf, noise, rir, 16000,
                  cfg, seed=seed))


def _write_scps(tmp_path, missing=False):
    rng = np.random.default_rng(3)
    lines = []
    for spk in range(3):
        for u in range(2):
            path = tmp_path / f"s{spk}_{u}.wav"
            if not missing:
                write_wav(path, (0.3 * rng.standard_normal(
                    12000 + 2000 * u)).astype(np.float32), 16000)
            lines.append(f"u{spk}_{u} spk{spk} {path}")
    (tmp_path / "speech.scp").write_text("\n".join(lines) + "\n")
    write_wav(tmp_path / "noise.wav",
              (0.1 * rng.standard_normal(20000)).astype(np.float32), 16000)
    (tmp_path / "noise.scp").write_text(
        f"n0 16000 1000 16000 {tmp_path / 'noise.wav'}\n")
    write_wav(tmp_path / "rir.wav", _rir()[0], 16000)
    (tmp_path / "rir.scp").write_text(f"r0 {tmp_path / 'rir.wav'}\n")
    return dict(speech_scp=str(tmp_path / "speech.scp"),
                noise_scp=[str(tmp_path / "noise.scp")],
                rir_scp=str(tmp_path / "rir.scp"))


def test_load_scp_and_waveinfo(tmp_path):
    scps = _write_scps(tmp_path)
    for kind in ("speech", "noise", "rir"):
        got = t_dm.load_scp(scps[f"{kind}_scp"], kind)
        want = j_dm.load_scp(scps[f"{kind}_scp"], kind)
        assert [vars(x) for x in got] == [vars(x) for x in want]


def test_iterator_batches_equal_jax(tmp_path):
    scps = _write_scps(tmp_path)
    kw = dict(scps, batch_size=3, cut_duration=[0.5, 0.6], enroll_duration=0.4,
              num_workers=1, samples_per_epoch=12, seed=5, process_index=0,
              process_count=1)
    got = list(t_dm.TrainDataIterator(**kw))
    want = list(j_dm.TrainDataIterator(**kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _equal(g, w)


def test_iterator_rank_from_torch_distributed(tmp_path, monkeypatch):
    scps = _write_scps(tmp_path)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    it = t_dm.TrainDataIterator(**scps, batch_size=2, samples_per_epoch=8)
    assert (it.rank, it.world_size, len(it)) == (1, 2, 2)


def test_producer_error_reaches_the_consumer(tmp_path):
    """Every speech wav is missing: the sample's three loads fail and the
    error is raised in the consumer, not swallowed by a dead thread."""
    scps = _write_scps(tmp_path, missing=True)
    it = t_dm.TrainDataIterator(**scps, batch_size=2, num_workers=2,
                                samples_per_epoch=4)
    result = {}

    def consume():
        try:
            list(it)
        except RuntimeError as e:
            result["error"] = e

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive(), "the consumer hangs"
    assert "failed to load" in str(result.get("error"))


def test_prefetcher_order_content_and_passthrough():
    batches = [("tse", np.full((2, 3), i, np.float32), None, [f"u{i}"])
               for i in range(7)]
    got = list(t_dm.Prefetcher(iter(batches), "cpu", depth=2))
    assert len(got) == 7
    for i, (mode, x, none, names) in enumerate(got):
        assert mode == "tse" and none is None and names == [f"u{i}"]
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), batches[i][1])


def test_prefetcher_passes_errors():
    def items():
        yield ("se", np.zeros(2, np.float32))
        raise OSError("disk gone")

    it = iter(t_dm.Prefetcher(items(), "cpu"))
    assert next(it)[0] == "se"
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_stopping_early_stops_the_producer():
    produced = []

    def items():
        for i in range(1000):
            produced.append(i)
            yield (np.zeros(1, np.float32),)

    it = iter(t_dm.Prefetcher(items(), "cpu", depth=2))
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    n = len(produced)
    while time.monotonic() < deadline:
        time.sleep(0.3)
        if len(produced) == n:
            break
        n = len(produced)
    assert len(produced) < 1000


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_load_yaml(path):
    assert t_config.load_yaml(path) == yaml.safe_load(path.read_text())


def test_from_dict():
    import dataclasses

    @dataclasses.dataclass
    class Inner:
        a: int = 1
        b: tuple = ()

    @dataclasses.dataclass
    class Outer:
        inner: Inner = dataclasses.field(default_factory=Inner)
        name: str = "x"

    o = t_config.from_dict(Outer, {"inner": {"a": 3, "b": [1, 2]},
                                   "name": "y"})
    assert o == Outer(Inner(3, (1, 2)), "y")
    with pytest.raises(ValueError):
        t_config.from_dict(Outer, {"nope": 1})


def test_metrics_logger(tmp_path, capsys):
    path = tmp_path / "sub" / "metrics.jsonl"
    with MetricsLogger(str(path)) as log:
        log.log(1, loss=np.float32(2.5), task="se")
        log.log(2, loss=torch.tensor(1.5), acc=0.25)
    recs = [json.loads(l) for l in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["loss"] == 2.5 and recs[0]["task"] == "se"
    assert recs[1]["loss"] == 1.5 and recs[1]["acc"] == 0.25
    assert all("wall_s" in r for r in recs)
    assert capsys.readouterr().out.count("\n") == 2
