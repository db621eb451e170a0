"""The port's recorder of spans and counters (``utils/profiling.py``) and
the spans of the paths the benchmark runs: the serving engine, UniSE's SFT
step with its data pipeline, the HCodec-1.0 round trip.

Off, the recorder enters no profiler range, reads no clock and keeps
nothing; on, spans nest by thread, carry their attributes and show in a
profiler trace as ``ua:<name>``; counts from many threads add up. The
tiny CPU stacks below are the port's own modules at test widths with
random weights (no JAX).
"""
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unified_audio_tpu_torch import cli
from unified_audio_tpu_torch.data.audio_io import write_wav
from unified_audio_tpu_torch.data.data_module import (Prefetcher,
                                                      TrainDataIterator)
from unified_audio_tpu_torch.models.bicodec.bicodec import (BiCodec,
                                                            BiCodecConfig)
from unified_audio_tpu_torch.models.bicodec.tokenizer import BiCodecTokenizer
from unified_audio_tpu_torch.models.hcodec.codec import hcodec10_config
from unified_audio_tpu_torch.models.lm.llama import LlamaConfig
from unified_audio_tpu_torch.models.lm.sft import LLMSFT
from unified_audio_tpu_torch.models.ssl.wav2vec2 import (SSLConfig,
                                                         Wav2Vec2Model)
from unified_audio_tpu_torch.models.unise.model import (TASK_MAP, UniSE,
                                                        UniSEConfig)
from unified_audio_tpu_torch.serve.engine import Request
from unified_audio_tpu_torch.train.optim import Optimizer
from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer
from unified_audio_tpu_torch.utils import profiling
from unified_audio_tpu_torch.utils.initialization import init_random_
from unified_audio_tpu_torch.utils.profiling import Recorder

torch.set_num_threads(2)  # several pytest workers share the machine


@pytest.fixture
def recording():
    """The process's recorder, emptied and on for the test, then off."""
    profiling.reset()
    profiling.enable()
    try:
        yield profiling.RECORDER
    finally:
        profiling.disable()
        profiling.reset()


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

def test_off_enters_no_range_reads_no_clock_keeps_nothing(monkeypatch):
    """Off (the default): ``span`` and ``cpu_time`` give one shared no-op
    context, ``count`` returns; no profiler range is entered (neither
    ``record_function`` nor the recorder's own) and no clock read;
    ``export`` is empty. (The process's recorder starts empty: a test
    that ran a profiled window before in this worker left what it
    recorded there.)"""
    profiling.reset()
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(profiling, "_range", lambda *a: calls.append(a))

    def clock():
        calls.append("clock")
        return 0

    monkeypatch.setattr(profiling, "time", SimpleNamespace(
        perf_counter_ns=clock, thread_time=clock, perf_counter=clock))
    assert not profiling.RECORDER.enabled
    with profiling.span("engine.step", n=3) as sp:
        sp.note(k=1)
        with profiling.span("engine.step.lm"):
            profiling.count("data.loader_cpu_s", 1.0)
    with profiling.cpu_time("data.loader_cpu_s"):
        pass
    assert profiling.span("a") is profiling.span("b") \
        is profiling.cpu_time("c")
    assert calls == []
    assert profiling.export() == {"spans": [], "counts": {}}


def test_nested_spans_threads_and_attrs():
    """On: each span has its thread's enclosing span as parent (another
    thread's open spans are not its parents), its native thread id, its
    attributes and those noted inside it; spans come out in the order they
    started."""
    rec = Recorder()
    rec.enable()
    other = {}

    def worker():
        with rec.span("worker", w=1) as sp:
            other["id"] = threading.get_native_id()
            other["span"] = sp.id

    with rec.span("outer", a=1) as outer:
        with rec.span("inner") as inner:
            inner.note(admitted=4)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with rec.span("inner"):
            pass
    out = rec.export()["spans"]
    assert [s["name"] for s in out] == ["outer", "inner", "worker", "inner"]
    o, i1, w, i2 = out
    assert o["parent"] is None and o["attrs"] == {"a": 1}
    assert i1["parent"] == o["id"] == i2["parent"]
    assert i1["attrs"] == {"admitted": 4}
    assert w["parent"] is None and w["id"] == other["span"]
    assert w["attrs"] == {"w": 1}
    me = threading.get_native_id()
    assert (o["thread"], i1["thread"], w["thread"]) == (me, me, other["id"])
    assert o["start_ns"] <= i1["start_ns"] <= i1["end_ns"] <= o["end_ns"]
    assert len({s["id"] for s in out}) == 4


def test_counts_from_eight_threads():
    """Counts added from 8 threads at once (a short switch interval, more
    threads than the tests' cores) lose no update; ``cpu_time`` adds a
    positive number of CPU seconds."""
    rec = Recorder()
    rec.enable()
    n = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(n):
                rec.count("ints")
                rec.count("halves", 0.5)
        threads = [threading.Thread(target=add) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    with rec.cpu_time("cpu_s"):
        sum(i * i for i in range(200000))
    counts = rec.export()["counts"]
    assert counts["ints"] == 8 * n and counts["halves"] == 4.0 * n
    assert counts["cpu_s"] > 0


def test_reset_export_and_disable():
    """``export`` is a copy of what was recorded since the last ``reset``;
    a span open across ``reset`` is recorded when it closes; after
    ``disable`` nothing more is recorded."""
    rec = Recorder()
    rec.enable()
    with rec.span("a"):
        rec.count("c", 2)
    first = rec.export()
    assert [s["name"] for s in first["spans"]] == ["a"]
    assert first["counts"] == {"c": 2}
    first["spans"][0]["attrs"]["x"] = 1
    assert rec.export()["spans"][0]["attrs"] == {}
    with rec.span("open"):
        rec.reset()
        assert rec.export() == {"spans": [], "counts": {}}
    assert [s["name"] for s in rec.export()["spans"]] == ["open"]
    rec.disable()
    with rec.span("b"):
        rec.count("c", 1)
    assert [s["name"] for s in rec.export()["spans"]] == ["open"]
    assert rec.export()["counts"] == {}


def test_spans_are_profiler_ranges(recording):
    """On, a span is a ``ua:`` range of ``torch.profiler`` holding the ops
    run inside it."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("engine.step", n=1):
            (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert profiling.PREFIX + "engine.step" in names
    assert [s["name"] for s in profiling.export()["spans"]] == [
        "engine.step"]


def test_on_while_a_profiler_runs():
    """Not enabled, the recorder is on while ``torch.profiler`` runs and
    off again after it; its ranges are operators' ranges, not user
    annotations, so the profiler makes no device copy of them."""
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.RECORDER.enabled
    profiling.reset()
    x = torch.randn(16, 16)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("engine.step", n=2):
                profiling.count("c", 3)
                (x @ x).sum()
        with profiling.span("after"):
            profiling.count("c", 1)
        out = profiling.export()
    finally:
        profiling.reset()
    assert [(s["name"], s["attrs"]) for s in out["spans"]] == [
        ("engine.step", {"n": 2})]
    assert out["counts"] == {"c": 3}
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == profiling.PREFIX + "engine.step"]
    assert len(ranges) == 1 and not ranges[0].is_user_annotation()


# ---------------------------------------------------------------------------
# The paths' spans, on tiny CPU stacks
# ---------------------------------------------------------------------------

def tiny_unise(tokenize=False):
    """UniSE at test widths (0.4-s segments; WavLM 24 wide; for training
    also BiCodec's tokenize side over a 17-layer, 16-wide XLSR), fp32 on
    the CPU, random weights as ``cli`` makes them."""
    cli._fp32_without_tf32()
    lm = LlamaConfig(global_size=64, semantic_size=64, hidden_size=32,
                     num_layers=2, num_heads=4)
    cfg = UniSEConfig(segment_seconds=0.4, feats_dim=24, global_tokens=4,
                      llm=lm)
    sft = LLMSFT(lm, num_tasks=len(TASK_MAP), feats_dim=cfg.feats_dim)
    wavlm = Wav2Vec2Model(SSLConfig(
        hidden_size=24, num_layers=2, num_heads=4, intermediate_size=32,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, use_rel_pos_bias=True,
        num_buckets=32, max_distance=80))
    bicodec = BiCodec(BiCodecConfig(
        ref_segment_duration=0.2, feat_dim=16, vocos_dim=32,
        vocos_intermediate_dim=64, vocos_num_layers=1, latent_dim=32,
        codebook_size=64, codebook_dim=8, spk_out_dim=32, spk_latent_dim=16,
        token_num=4, fsq_levels=(4, 4, 4), num_mels=32, mel_n_fft=256,
        mel_win=160, mel_hop=80, wave_channels=32), tokenize=tokenize)
    xlsr = None
    if tokenize:
        xlsr = Wav2Vec2Model(SSLConfig(
            hidden_size=16, num_layers=17, num_heads=2, intermediate_size=32,
            conv_dim=(16,) * 7, conv_bias=True, feat_extract_norm="layer",
            do_stable_layer_norm=True, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4))
    gen = torch.Generator().manual_seed(0)
    for m in (sft, wavlm, bicodec, xlsr):
        if m is not None:
            init_random_(m, gen).eval()
    return UniSE(cfg, BiCodecTokenizer(bicodec, xlsr), wavlm, sft)


def test_engine_spans_and_host_clocks(recording):
    """``admit_many``, ``step(n)`` and ``harvest`` without ``run``: one
    ``engine.admit`` (its attrs the admitted and the waves) around its
    stage, frontend, prefill and scatter; ``engine.step`` spans whose
    ``n`` add up to ``decode_steps``, each token's lm, sample and update
    inside; ``engine.harvest``; the ``t_*`` host clocks in ``stats()``.
    Detokenizing the results is ``unise.detokenize`` with its segments."""
    unise = tiny_unise()
    eng = cli.make_engine(unise, slots=2)
    rng = np.random.default_rng(0)
    seg = unise.config.segment_len
    sem = unise._semantic_len()
    reqs = [Request(task_id=t, mix_wav=0.3 * rng.standard_normal(
        seg).astype(np.float32), enroll_wav=None if t == 0 else
        0.3 * rng.standard_normal(seg).astype(np.float32), global_length=4,
        semantic_length=sem, do_sample=False, uid=i)
        for i, t in enumerate((0, 1))]
    before = eng.stats()
    for k in ("t_prestage", "t_admit", "t_step", "t_drain", "t_harvest"):
        assert before[k] == 0.0
    eng.prestage(reqs)
    assert eng.admit_many(reqs) == [0, 1]
    total = 4 + 1 + sem
    eng.step(total - 3)
    eng.step(2)
    eng.step(1)
    results = eng.harvest()
    assert sorted(r.uid for r in results) == [0, 1]
    g = np.stack([r.global_ids for r in results])
    s = np.stack([r.semantic_ids for r in results])
    unise._decode_tokens(g, s, 2 * seg)

    spans = profiling.export()["spans"]
    (admit,) = by_name(spans, "engine.admit")
    assert admit["attrs"] == {"admitted": 2, "waves": 1}
    assert [c["name"] for c in children(spans, admit)] == [
        "engine.admit.stage", "engine.admit.frontend",
        "engine.admit.prefill", "engine.admit.scatter"]
    steps = by_name(spans, "engine.step")
    assert [sp["attrs"]["n"] for sp in steps] == [total - 3, 2, 1]
    assert sum(sp["attrs"]["n"] for sp in steps) \
        == eng.stats()["decode_steps"] == total
    for sp in steps:
        assert [c["name"] for c in children(spans, sp)] == [
            "engine.step.lm", "engine.step.sample",
            "engine.step.update"] * sp["attrs"]["n"]
    assert len(by_name(spans, "engine.harvest")) == 1
    assert len(by_name(spans, "engine.prestage")) == 1
    (detok,) = by_name(spans, "unise.detokenize")
    assert detok["attrs"] == {"segments": 2}
    st = eng.stats()
    for k in ("t_prestage", "t_admit", "t_step", "t_harvest"):
        assert st[k] > 0.0, k
    assert st["t_drain"] == 0.0  # nothing was displaced
    assert st["t_admit"] >= (admit["end_ns"] - admit["start_ns"]) * 1e-9


def _write_corpus(root):
    rng = np.random.default_rng(3)
    lines = []
    for spk in range(2):
        for u in range(2):
            path = root / f"s{spk}_{u}.wav"
            write_wav(path, (0.3 * rng.standard_normal(9600)).astype(
                np.float32), 16000)
            lines.append(f"u{spk}_{u} spk{spk} {path}")
    (root / "speech.scp").write_text("\n".join(lines) + "\n")
    write_wav(root / "noise.wav",
              (0.1 * rng.standard_normal(16000)).astype(np.float32), 16000)
    (root / "noise.scp").write_text(
        f"n0 16000 0 16000 {root / 'noise.wav'}\n")
    rir = np.zeros(800, np.float32)
    rir[0] = 0.9
    write_wav(root / "rir.wav", rir, 16000)
    (root / "rir.scp").write_text(f"r0 {root / 'rir.wav'}\n")
    return dict(speech_scp=str(root / "speech.scp"),
                noise_scp=str(root / "noise.scp"),
                rir_scp=str(root / "rir.scp"))


def test_sft_step_spans_and_loader_cpu(recording, tmp_path):
    """A batch through the prefetcher and one ``train_step``: ``data.wait``
    on the consumer, ``data.stage`` on the staging thread,
    ``train.step`` around ``unise.frozen`` (the tokenizer's ``bicodec.xlsr``
    and ``bicodec.tokenize``, then ``unise.frozen.wavlm``),
    ``train.loss_backward`` and ``train.update``; the loader's
    workers add a positive ``data.loader_cpu_s``."""
    unise = tiny_unise(tokenize=True)
    trainer = SFTTrainer(unise, Optimizer(unise.sft.parameters(),
                                          warmup_steps=2))
    feed = iter(Prefetcher(TrainDataIterator(
        **_write_corpus(tmp_path), batch_size=2, cut_duration=0.4,
        enroll_duration=0.4, num_workers=2, samples_per_epoch=8, seed=1),
        "cpu"))
    mode, enroll, mix, speech, interf, *_ = next(feed)
    loss, _ = trainer.train_step(mode, enroll, mix,
                                 interf if mode == "rtse" else speech)
    feed.close()
    assert np.isfinite(loss)

    out = profiling.export()
    spans = out["spans"]
    assert by_name(spans, "data.wait")
    me = threading.get_native_id()
    assert by_name(spans, "data.stage")[0]["thread"] != me
    (step,) = by_name(spans, "train.step")
    assert step["attrs"] == {"task": mode}
    assert [c["name"] for c in children(spans, step)] == [
        "unise.frozen", "train.loss_backward", "train.update"]
    (frozen,) = by_name(spans, "unise.frozen")
    assert [c["name"] for c in children(spans, frozen)] == [
        "bicodec.xlsr", "bicodec.tokenize", "unise.frozen.wavlm"]
    assert out["counts"]["data.loader_cpu_s"] > 0


def test_hcodec_roundtrip_spans(recording):
    """A tiny HCodec-1.0 round trip: ``codec.features`` and
    ``codec.encode`` (its latents and quantize) inside ``tokenize``, then
    ``codec.decode``."""
    tok = cli._build_hcodec("hcodec10", cfg=hcodec10_config(
        latent_dim=64, seanet_filters=4, codebook_size=32,
        num_quantizers=2, decoder_dim=64, decoder_intermediate_dim=128,
        decoder_convnext_layers=2, semantic_encode_channels=64,
        feat_dim=32), ssl_cfg=SSLConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=32,
            conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4))
    wav = 0.3 * torch.randn(2, 640 * 8, generator=torch.Generator()
                            .manual_seed(0))
    a, s = tok.tokenize(wav)
    assert tok.detokenize(a, s).shape == (2, 640 * 8)
    spans = profiling.export()["spans"]
    assert [sp["name"] for sp in spans if sp["parent"] is None] == [
        "codec.features", "codec.encode", "codec.decode"]
    (enc,) = by_name(spans, "codec.encode")
    assert [c["name"] for c in children(spans, enc)] == [
        "codec.encode.latents", "codec.encode.quantize"]
    assert all(sp["end_ns"] >= sp["start_ns"] for sp in spans)
    assert time.perf_counter_ns() >= spans[-1]["end_ns"]
