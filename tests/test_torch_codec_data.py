"""Codec training's data iterators of the port
(``unified_audio_tpu_torch.data.hcodec_data``) against the JAX package's on
the same SCP lists and seeds: the batches and their domains exactly equal
with one worker, and a domain whose every wav fails raises in the consumer.
"""
import numpy as np
import pytest

from unified_audio_tpu.data import hcodec_data as j_data
from unified_audio_tpu_torch.data import hcodec_data as t_data
from unified_audio_tpu_torch.data.audio_io import write_wav


@pytest.fixture(scope="module")
def domains(tmp_path_factory):
    """Three domains of wavs, some shorter than the 0.25-s crop (wrapped)
    and some longer (cut at a random offset)."""
    tmp = tmp_path_factory.mktemp("domains")
    rng = np.random.default_rng(0)
    scps = {}
    for d, lengths in (("speech", (3000, 6000, 9000)), ("music", (2000,
                                                                  7000)),
                       ("audio", (5000,))):
        lines = []
        for i, n in enumerate(lengths):
            path = tmp / f"{d}{i}.wav"
            write_wav(path, (0.3 * rng.standard_normal(n)).astype(
                np.float32), 16000)
            lines.append(f"{d}{i} spk {path}")
        (tmp / f"{d}.scp").write_text("\n".join(lines) + "\n")
        scps[d] = [str(tmp / f"{d}.scp")]
    return scps


def test_domain_weighted_iterator_equals_jax(domains):
    """At ``num_workers=1``: the same (wav (4, 4000), domain) batches,
    bit for bit, in the same order, domains drawn by the weights."""
    kw = dict(domain_weights={"speech": 0.6, "music": 0.3, "audio": 0.1},
              batch_size=4, cut_seconds=0.25, num_workers=1,
              samples_per_epoch=48, seed=3)
    want = list(j_data.DomainWeightedIterator(domains, **kw))
    got = list(t_data.DomainWeightedIterator(domains, **kw))
    assert len(got) == len(want) == 12
    for (gw, gd), (ww, wd) in zip(got, want):
        assert gd == wd
        assert gw.dtype == np.float32 and gw.shape == (4, 4000)
        np.testing.assert_array_equal(gw, ww)
    assert len({d for _, d in got}) > 1


def test_round_robin_val_iterator_equals_jax(domains):
    """The domains in turn, the i-th wav of each cut from its start (or
    wrapped): equal to JAX's."""
    want = list(j_data.RoundRobinValIterator(domains, cut_seconds=0.25,
                                             limit_per_domain=3))
    got = list(t_data.RoundRobinValIterator(domains, cut_seconds=0.25,
                                            limit_per_domain=3))
    assert [d for _, d in got] == [d for _, d in want] == \
        ["speech", "music", "audio"] * 3
    for (gw, _), (ww, _) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)


def test_failing_domain_raises_in_the_consumer(domains, tmp_path):
    """A domain whose every wav fails to load raises the producer's error
    in the consumer (the JAX iterator waits forever there)."""
    (tmp_path / "bad.scp").write_text(f"x0 s {tmp_path / 'missing.wav'}\n")
    it = t_data.DomainWeightedIterator({"bad": [str(tmp_path / "bad.scp")]},
                                       batch_size=2, cut_seconds=0.25,
                                       num_workers=2, samples_per_epoch=8)
    with pytest.raises(RuntimeError, match="failed to load from domain bad"):
        next(iter(it))


def test_empty_domain_refused(tmp_path):
    (tmp_path / "empty.scp").write_text("")
    with pytest.raises(ValueError, match="empty domain"):
        t_data.DomainWeightedIterator({"e": [str(tmp_path / "empty.scp")]})
