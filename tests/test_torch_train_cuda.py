"""UniSE's SFT training on the card against the same training on the CPU,
on a tiny stack with seeded random weights (the tokenizing BiCodec over a
17-layer XLSR-shaped SSL, a 2-layer WavLM, a 2-layer LM), fp32 with TF32
off: the frozen tokenizer's tokens, the loss, every LM gradient and two
optimizer updates from the same gradients; and the pinned-memory
prefetcher's CUDA tensors. Needs a CUDA card; imports no JAX:

    python -m pytest tests/test_torch_train_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from unified_audio_tpu_torch.data.data_module import Prefetcher
from unified_audio_tpu_torch.models.bicodec.bicodec import (BiCodec,
                                                            BiCodecConfig)
from unified_audio_tpu_torch.models.bicodec.tokenizer import BiCodecTokenizer
from unified_audio_tpu_torch.models.lm.llama import LlamaConfig
from unified_audio_tpu_torch.models.lm.sft import LLMSFT
from unified_audio_tpu_torch.models.ssl.wav2vec2 import SSLConfig, Wav2Vec2Model
from unified_audio_tpu_torch.models.unise.model import UniSE, UniSEConfig
from unified_audio_tpu_torch.train.optim import Optimizer
from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer
from unified_audio_tpu_torch.utils.initialization import init_random_

SEG = 6400


def _stack(device, seed=0):
    """The tiny UniSE stack on ``device``, weights from ``seed``."""
    cfg = UniSEConfig(segment_seconds=0.4, feats_dim=24, global_tokens=4,
                      llm=LlamaConfig(global_size=64, semantic_size=64,
                                      hidden_size=32, num_layers=2,
                                      num_heads=4))
    xlsr = SSLConfig(hidden_size=16, num_layers=17, num_heads=2,
                     intermediate_size=32, conv_dim=(16,) * 7,
                     conv_bias=True, feat_extract_norm="layer",
                     do_stable_layer_norm=True, num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=4)
    wavlm = SSLConfig(hidden_size=24, num_layers=2, num_heads=4,
                      intermediate_size=32, conv_dim=(16,) * 7,
                      num_conv_pos_embeddings=16,
                      num_conv_pos_embedding_groups=4, use_rel_pos_bias=True,
                      num_buckets=32, max_distance=80)
    bicodec = BiCodecConfig(
        ref_segment_duration=0.2, feat_dim=16, vocos_dim=32,
        vocos_intermediate_dim=64, vocos_num_layers=1, latent_dim=32,
        codebook_size=64, codebook_dim=8, spk_out_dim=32, spk_latent_dim=16,
        token_num=4, fsq_levels=(4, 4, 4), num_mels=32, mel_n_fft=256,
        mel_win=160, mel_hop=80, wave_channels=32)
    gen = torch.Generator().manual_seed(seed)
    mods = [LLMSFT(cfg.llm, feats_dim=cfg.feats_dim), Wav2Vec2Model(wavlm),
            BiCodec(bicodec, tokenize=True), Wav2Vec2Model(xlsr)]
    for m in mods:
        init_random_(m, gen)
    sft, wl, bc, xl = (m.to(device).eval() for m in mods)
    return UniSE(cfg, BiCodecTokenizer(bc, xl), wl, sft)


@pytest.mark.requires_cuda
class TestTrainingOnCard:
    @pytest.fixture
    def card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda")

    @staticmethod
    def _wavs(seed, b=2):
        rng = np.random.default_rng(seed)
        return [(0.3 * rng.standard_normal((b, SEG))).astype(np.float32)
                for _ in range(3)]

    def test_tokens_match_cpu(self, card):
        cpu, gpu = _stack("cpu"), _stack(card)
        wav = self._wavs(1, b=4)[0]
        cg, cs = cpu.tokenizer.tokenize(torch.as_tensor(wav))
        gg, gs = gpu.tokenizer.tokenize(torch.as_tensor(wav, device=card))
        same = np.concatenate([(gg.cpu() == cg).numpy().ravel(),
                               (gs.cpu() == cs).numpy().ravel()])
        assert same.mean() >= 0.999, f"{same.mean():.4f} of tokens equal"

    def test_loss_grads_and_updates_match_cpu(self, card):
        """The loss within 1e-4 relative and every gradient within 1e-3 of
        its largest entry; then two updates (rate 0, then the peak) from the
        CPU's gradients on both sides leave the LM within 1e-6. The same
        gradients go to both optimizers because Adam's m / sqrt(v) turns a
        near-zero gradient into +-1 by its sign, which card and CPU may
        round apart."""
        stacks = [_stack("cpu"), _stack(card)]
        trainers = [SFTTrainer(u, Optimizer(u.sft.parameters(),
                                            warmup_steps=1)) for u in stacks]
        enroll, mix, target = self._wavs(2)
        losses, grads = [], []
        for u, t in zip(stacks, trainers):
            frozen = u.frozen_inputs(*(torch.as_tensor(x, device=t.device())
                                       for x in (enroll, mix, target)))
            loss, _ = t.loss_backward("tse", frozen)
            losses.append(loss.item())
            grads.append({k: p.grad.cpu() for k, p in
                          u.sft.named_parameters()})
        assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
        for k, g in grads[0].items():
            err = (grads[1][k] - g).abs().max() / g.abs().max().clamp(
                min=1e-30)
            assert err <= 1e-3, f"{k}: {err:.3e}"
        for _ in range(2):
            for u, t in zip(stacks, trainers):
                for k, p in u.sft.named_parameters():
                    p.grad = grads[0][k].to(p.device, copy=True)
                t.update()
        assert trainers[1].optimizer.lr == trainers[0].optimizer.lr
        for (k, a), b in zip(stacks[0].sft.state_dict().items(),
                             stacks[1].sft.state_dict().values()):
            torch.testing.assert_close(b.cpu(), a, atol=1e-6, rtol=0,
                                       msg=k)

    def test_prefetcher_delivers_cuda_tensors(self, card):
        batches = [("tse", np.full((2, 5), i, np.float32), None, [i])
                   for i in range(5)]
        got = list(Prefetcher(iter(batches), card, depth=2))
        assert len(got) == 5
        for i, (mode, x, none, names) in enumerate(got):
            assert x.is_cuda and mode == "tse" and none is None
            assert names == [i]
            assert torch.equal(x.cpu(), torch.full((2, 5), float(i)))
