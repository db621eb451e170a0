"""The port's parallel training on the card, at world size 1 through NCCL
(one card: NCCL refuses two ranks on one device). Each test runs a step
with a mesh of size 1 and the same step without one, from the same
weights and batch: the explicit gradient reduction, the mesh-aware clip
and the collectives on size-1 groups must change nothing.

* UniSE's SFT step at a tiny size on a (dp 1, tp 1) mesh and on a pp = 1
  mesh (2 microbatches) against the mesh-less trainer: loss, accuracy and
  every updated weight within 1e-5;
* ``CodecGANTrainer(mesh=)`` at dp = 1, two steps (the second with the GAN
  terms): metrics and the EMA buffers within 1e-5 of the mesh-less
  trainer's, K5 launched in the mesh run;
* ``llama_pipeline_forward`` (pp = 1, 2 microbatches) and
  ``llama_sequence_parallel_forward`` (sp = 1) equal the dense backbone
  within 1e-5.

Needs a CUDA card; imports no JAX:

    python -m pytest tests/test_torch_parallel_cuda.py --noconftest -q
"""
import socket

import pytest
import torch

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(scope="module")
def nccl():
    """A world-1 NCCL group for the module, and the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from unified_audio_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    assert torch.distributed.get_backend() == "nccl"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the two runs of a test must differ only by the mesh: deterministic
    # kernels (a nondeterministic gradient, through Adam's sign-like first
    # steps, would part them by more than the mesh does)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(False)
    torch.distributed.destroy_process_group()


def tiny_unise(card, seed=3):
    """A tiny training UniSE (the CPU tests' sizes) with random weights."""
    from unified_audio_tpu_torch.models.bicodec.bicodec import (BiCodec,
                                                                 BiCodecConfig)
    from unified_audio_tpu_torch.models.bicodec.tokenizer import (
        BiCodecTokenizer)
    from unified_audio_tpu_torch.models.lm.llama import LlamaConfig
    from unified_audio_tpu_torch.models.lm.sft import LLMSFT
    from unified_audio_tpu_torch.models.ssl.wav2vec2 import (SSLConfig,
                                                             Wav2Vec2Model)
    from unified_audio_tpu_torch.models.unise.model import (UniSE,
                                                            UniSEConfig)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    bcfg = BiCodecConfig(
        ref_segment_duration=0.2, feat_dim=16, vocos_dim=32,
        vocos_intermediate_dim=64, vocos_num_layers=1, latent_dim=32,
        codebook_size=64, codebook_dim=8, spk_out_dim=32, spk_latent_dim=16,
        token_num=4, fsq_levels=(4, 4, 4), num_mels=32, mel_n_fft=256,
        mel_win=160, mel_hop=80, wave_channels=32, wave_rates=(8, 5, 4, 2),
        wave_kernels=(16, 11, 8, 4))
    xcfg = SSLConfig(hidden_size=16, num_layers=17, num_heads=2,
                     intermediate_size=32, conv_dim=(16,) * 7, conv_bias=True,
                     feat_extract_norm="layer", do_stable_layer_norm=True,
                     num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=4)
    wcfg = SSLConfig(hidden_size=24, num_layers=2, num_heads=4,
                     intermediate_size=32, conv_dim=(16,) * 7,
                     num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=4, use_rel_pos_bias=True,
                     num_buckets=32, max_distance=80)
    cfg = UniSEConfig(segment_seconds=0.4, feats_dim=24, global_tokens=4,
                      llm=LlamaConfig(global_size=64, semantic_size=64,
                                      hidden_size=32, num_layers=2,
                                      num_heads=4))
    gen = torch.Generator(device=card).manual_seed(seed)
    with torch.device(card):
        bicodec = BiCodec(bcfg, tokenize=True)
        xlsr, wavlm = Wav2Vec2Model(xcfg), Wav2Vec2Model(wcfg)
        sft = LLMSFT(cfg.llm, num_tasks=3, feats_dim=cfg.feats_dim)
    for m in (bicodec, xlsr, wavlm, sft):
        init_random_(m, gen)
    return UniSE(cfg, BiCodecTokenizer(bicodec, xlsr).eval(), wavlm.eval(),
                 sft)


@pytest.mark.parametrize("kind", ["dp_tp", "pp"])
def test_sft_step_with_mesh_equals_without(nccl, kind):
    from unified_audio_tpu_torch.parallel import mesh as mesh_lib
    from unified_audio_tpu_torch.train.optim import Optimizer
    from unified_audio_tpu_torch.train.sft_trainer import SFTTrainer

    g = torch.Generator(device=nccl).manual_seed(7)
    batch = [0.3 * torch.randn(4, 6400, device=nccl, generator=g)
             for _ in range(3)]
    out = []
    for mesh in (None, mesh_lib.make_mesh_axes(dp=1, tp=1) if kind == "dp_tp"
                 else mesh_lib.make_mesh_axes(pp=1)):
        unise = tiny_unise(nccl)
        opt = Optimizer(unise.sft.parameters(), warmup_steps=1)
        kw = ({} if mesh is None else {"mesh": mesh} if kind == "dp_tp"
              else {"pp_mesh": mesh, "pp_microbatches": 2})
        trainer = SFTTrainer(unise, opt, **kw)
        losses = [trainer.train_step("tse", *batch) for _ in range(2)]
        out.append((losses, trainer.state_dict()["state_dict"]))
    (l0, sd0), (l1, sd1) = out
    for a, b in zip(l0, l1):
        assert abs(a[0] - b[0]) <= 1e-5 * abs(a[0]) and abs(a[1] - b[1]) \
            <= 1e-5
    for k, v in sd0.items():
        assert (v - sd1[k]).abs().max() <= 1e-5, k


def test_codec_step_with_mesh_equals_without(nccl):
    from unified_audio_tpu_torch.models.hcodec.codec import (HCodec,
                                                             hcodec10_config)
    from unified_audio_tpu_torch.ops.cuda import vq
    from unified_audio_tpu_torch.parallel import mesh as mesh_lib
    from unified_audio_tpu_torch.train.codec_trainer import (
        CodecGANTrainer, CodecTrainConfig)
    from unified_audio_tpu_torch.train.discriminators import (
        CodecDiscriminator)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = hcodec10_config(latent_dim=64, seanet_filters=4, codebook_size=32,
                          num_quantizers=2, decoder_dim=64,
                          decoder_intermediate_dim=128,
                          decoder_convnext_layers=2,
                          semantic_encode_channels=64, feat_dim=32)
    g = torch.Generator(device=nccl).manual_seed(5)
    wav = 0.3 * torch.randn(4, 5120, device=nccl, generator=g)
    feat = torch.randn(4, 16, 32, device=nccl, generator=g)
    runs = []
    for mesh in (None, mesh_lib.make_mesh_axes(dp=1)):
        gen = torch.Generator(device=nccl).manual_seed(0)
        with torch.device(nccl):
            codec, disc = HCodec(cfg, trainable=True), CodecDiscriminator()
        init_random_(codec, gen)
        init_random_(disc, gen)
        trainer = CodecGANTrainer(codec, CodecTrainConfig(
            perceptual_start_step=1), disc, torch.Generator().manual_seed(1),
            mesh=mesh)
        before = vq.nearest_code.launches
        metrics = [trainer.train_step(wav, feat) for _ in range(2)]
        runs.append((metrics, vq.nearest_code.launches - before,
                     {k: v.clone() for k, v in codec.state_dict().items()
                      if "._codebook." in k}))
    (m0, _, b0), (m1, k5, b1) = runs
    assert k5 > 0
    for a, b in zip(m0, m1):
        for k, v in a.items():
            assert abs(v - b[k]) <= 1e-5 * max(abs(v), 1e-6), (k, v, b[k])
    for k, v in b0.items():
        assert (v - b1[k]).abs().max() <= 1e-5 * max(v.abs().max(), 1), k


def test_pipeline_and_sequence_forwards_equal_dense(nccl):
    from unified_audio_tpu_torch.models.lm.llama import (LlamaBackbone,
                                                         LlamaConfig)
    from unified_audio_tpu_torch.parallel import mesh as mesh_lib
    from unified_audio_tpu_torch.parallel.pipeline import (
        llama_pipeline_forward)
    from unified_audio_tpu_torch.parallel.sequence import (
        llama_sequence_parallel_forward)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = LlamaConfig(hidden_size=64, num_layers=4, num_heads=4)
    gen = torch.Generator(device=nccl).manual_seed(2)
    with torch.device(nccl):
        bb = LlamaBackbone(cfg)
    init_random_(bb, gen)
    x = torch.randn(4, 24, 64, device=nccl, generator=gen)
    with torch.no_grad():
        dense = bb.backbone(x)
        pipe = bb.norm(llama_pipeline_forward(
            bb, x, mesh_lib.make_mesh_axes(pp=1), 2))
        seq = bb.norm(llama_sequence_parallel_forward(
            bb, x, mesh_lib.make_mesh_axes(sp=1)))
    assert (pipe - dense).abs().max() <= 1e-5
    assert (seq - dense).abs().max() <= 1e-5
