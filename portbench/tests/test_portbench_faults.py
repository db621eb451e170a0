"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, release, check) on the CPU at tiny sizes,
without the look for a card, once sound and once for each fault the cell
can have. The cells run on one card: no exchange between cards exists to
leave out."""
import pytest
import torch

from portbench.harness import manifest
from portbench.tests import tiny


def correct(cell, seed=21):
    run = tiny.run(cell, seed=seed, seconds=0.0)
    drv = manifest.load_module(manifest.driver_path(run.cell["driver"]),
                               "drivers." + run.cell["driver"])
    st = drv.setup(run)
    out = drv.window(run, st)
    drv.release(run, st)
    checks = drv.check(run, st, out)
    return all(c["value"] <= c["limit"] for c in checks), checks


def serve_token_altered(mp):
    from unified_audio_tpu_torch.serve import engine
    real = engine.sample_logits_vec
    def altered(generator, logits, *a, **k):
        # the runner-up of the phase's range in place of each token
        real(generator, logits, *a, **k)
        return torch.topk(logits, 2, dim=-1).indices[:, 1].int()
    mp.setattr(engine, "sample_logits_vec", altered)


def serve_sampling_unfiltered(mp):
    from unified_audio_tpu_torch.serve import engine
    real = engine.sample_logits_vec

    def unfiltered(generator, logits, temperature, top_k, top_p, *a, **k):
        # every code of the range in the draw: top-k and top-p skipped
        return real(generator, logits, temperature,
                    torch.full_like(top_k, k.get("max_top_k", 256)),
                    torch.ones_like(top_p), *a, **k)
    mp.setattr(engine, "sample_logits_vec", unfiltered)


def serve_state_unchanged(mp):
    from unified_audio_tpu_torch.serve import engine
    mp.setattr(engine.ContinuousBatchingEngine, "_step_one",
               lambda self, generator, nb: None)


def serve_segment_left_out(mp):
    from unified_audio_tpu_torch.models.unise import model
    real = model.UniSE._decode_tokens

    def half(self, g, s, n):
        out = real(self, g, s, n)
        out[len(out) // 2:] = 0.0
        return out
    mp.setattr(model.UniSE, "_decode_tokens", half)


def codec_code_altered(mp):
    from unified_audio_tpu_torch.ops.cuda import vq
    real = vq.rvq_encode_fused

    def shifted(x, books):
        codes = real(x, books)
        codes[:, 0] = (codes[:, 0] + 1) % books[0].shape[0]
        return codes
    mp.setattr(vq, "rvq_encode_fused", shifted)


def codec_half_batch_left_out(mp):
    from unified_audio_tpu_torch.models.hcodec import tokenizer
    real = tokenizer.HCodecTokenizer.detokenize

    def half(self, a, s):
        out = real(self, a, s)
        out[out.shape[0] // 2:] = 0.0
        return out
    mp.setattr(tokenizer.HCodecTokenizer, "detokenize", half)


def train_state_unchanged(mp):
    from unified_audio_tpu_torch.train import optim
    mp.setattr(optim.Optimizer, "step", lambda self: None)


def train_params_not_written(mp):
    """The update computed, Adam's state kept, the parameters left as
    they were."""
    from unified_audio_tpu_torch.train import optim
    real = optim.Optimizer.step

    def step(self):
        kept = [q.detach().clone() for q in self.params]
        real(self)
        with torch.no_grad():
            for q, k in zip(self.params, kept):
                q.copy_(k)
    mp.setattr(optim.Optimizer, "step", step)


def train_update_reversed(mp):
    """Each update applied with its sign turned."""
    from unified_audio_tpu_torch.train import optim
    real = optim.Optimizer.step

    def step(self):
        kept = [q.detach().clone() for q in self.params]
        real(self)
        with torch.no_grad():
            for q, k in zip(self.params, kept):
                q.copy_(2 * k - q)
    mp.setattr(optim.Optimizer, "step", step)


def train_half_batch_left_out(mp):
    from unified_audio_tpu_torch.train import sft_trainer
    real = sft_trainer.SFTTrainer.loss_backward

    def half(self, task, frozen):
        n = frozen[1].shape[0] // 2
        return real(self, task, tuple(None if x is None else x[:n]
                                      for x in frozen))
    mp.setattr(sft_trainer.SFTTrainer, "loss_backward", half)


def train_token_altered(mp):
    from unified_audio_tpu_torch.models.bicodec import tokenizer
    real = tokenizer.BiCodecTokenizer.tokenize

    def shifted(self, wav):
        g, s = real(self, wav)
        return g, (s + 1) % self.config.codebook_size
    mp.setattr(tokenizer.BiCodecTokenizer, "tokenize", shifted)


SERVE, CODEC = "unise-serve-c96-s64", "hcodec10-roundtrip-b16x10s"
TRAIN = "unise-train-sft-b32x5s"


@pytest.mark.parametrize("cell", [SERVE, CODEC, TRAIN])
def test_sound_run_is_correct(cell):
    ok, checks = correct(cell)
    assert ok, checks


def test_training_run_led_by_se_is_correct():
    """A first step of SE leaves the enrollment's SOS unreached: the
    program's optimizer gives it a zero gradient, as optax does, and the
    reference has to count and decay it alike."""
    run = tiny.run(TRAIN, seed=1)
    drv = manifest.load_module(manifest.driver_path(run.cell["driver"]),
                               "drivers." + run.cell["driver"])
    st = drv.setup(run)
    out = drv.window(run, st)
    drv.release(run, st)
    assert st.first[0]["mode"] == "se"
    checks = drv.check(run, st, out)
    assert all(c["value"] <= c["limit"] for c in checks), checks


@pytest.mark.parametrize("cell,fault", [
    (SERVE, serve_token_altered), (SERVE, serve_sampling_unfiltered),
    (SERVE, serve_state_unchanged),
    (SERVE, serve_segment_left_out), (CODEC, codec_code_altered),
    (CODEC, codec_half_batch_left_out), (TRAIN, train_state_unchanged),
    (TRAIN, train_params_not_written), (TRAIN, train_update_reversed),
    (TRAIN, train_half_batch_left_out), (TRAIN, train_token_altered)])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = correct(cell)
    assert not ok, checks
