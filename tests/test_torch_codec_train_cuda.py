"""Codec training's nearest-code searches on the card: K5 (the cluster-split
kernel of ``csrc/vq.cu``) on the codebooks k-means starts from when a batch
has fewer rows than codes, where ``sample_rows`` draws rows with
replacement and the codebook holds exact duplicates in different chunks of
the cluster (so in different CTAs, merged in distributed shared memory).
Each row's code must be the lowest index among equal distances, as
``jnp.argmin`` and the plain search give. Also a causal HCodec-1.0
training step on the card, every K5 search of its k-means and EMA layers
equal to the plain search. Needs a CUDA card; imports no JAX:

    python -m pytest tests/test_torch_codec_train_cuda.py --noconftest -q
"""
import pytest
import torch

from unified_audio_tpu_torch.ops import quant
from unified_audio_tpu_torch.ops.cuda import vq


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m", [600, 240])
def test_k5_duplicated_codebook_takes_lowest_code(card, m):
    """M = 600 (a batch of 8 x 75 frames; 32 rows a cluster) and M = 240
    (16 rows a cluster), N = 1024, D = 512: the codebook is 1024 rows drawn
    with replacement from the M samples. The samples themselves and noisy
    copies of them get K5's codes equal to ``nearest_code_ref``'s; a
    sample's code is the lowest index holding its row, and some of its
    duplicates lie in other chunks of the cluster."""
    g = torch.Generator().manual_seed(m)
    samples = torch.randn(m, 512, generator=g)
    idx = quant.sample_rows(m, 1024, g)
    codebook = samples[idx].to(card)
    chunk = -(-1024 // vq.CLUSTER)
    spread = {}
    for j, i in enumerate(idx.tolist()):
        spread.setdefault(i, set()).add(j // chunk)
    assert sum(len(c) > 1 for c in spread.values()) > m // 4
    first = {}
    for j, i in enumerate(idx.tolist()):
        first.setdefault(i, j)
    for x in (samples, samples + 1e-3 * torch.randn(m, 512, generator=g)):
        x = x.to(card).contiguous()
        got = vq.nearest_code(x, codebook)
        want = vq.nearest_code_ref(x, codebook)
        assert torch.equal(got, want)
    got = vq.nearest_code(samples.to(card), codebook).cpu()
    for i, code in enumerate(got.tolist()):
        if i in first:
            assert code == first[i], (i, code, first[i])


@pytest.mark.requires_cuda
def test_kmeans_on_card_equals_cpu(card):
    """k-means at the training shape (M = 600 rows, N = 1024, D = 512, the
    same initial rows) through K5 on the card and the plain search on the
    CPU: bins equal, means within 1e-5."""
    g = torch.Generator().manual_seed(1)
    samples = torch.randn(600, 512, generator=g)
    rows = quant.sample_rows(600, 1024, g)
    before = vq.nearest_code.launches
    out = {}
    for dev in ("cpu", card):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(quant, "sample_rows", lambda *a, **k: rows)
            out[str(dev)] = quant.kmeans(samples.to(dev), 1024, 50)
    assert vq.nearest_code.launches - before == 51
    (cm, cb), (gm, gb) = out["cpu"], out[str(card)]
    assert torch.equal(cb, gb.cpu())
    assert (cm - gm.cpu()).abs().max() <= 1e-5


@pytest.mark.requires_cuda
def test_causal_training_step_k5_codes_equal_plain(card):
    """One ``forward(train=True)`` of a causal HCodec-1.0 (the shipped
    encoder, latent 512 and 1024 codes; a narrower decoder) on 2 x 0.32 s
    on the card: every nearest-code search of the step (k-means' 51 a layer
    on the first batch, then the EMA layer's) launches K5 and gives the
    plain search's codes; the loss is finite. The draws (k-means' rows, the
    dropout cutoff) come from a host generator, as ``CodecGANTrainer``
    draws them."""
    from unified_audio_tpu_torch.models.hcodec.codec import (HCodec,
                                                             hcodec10_config)
    from unified_audio_tpu_torch.utils.initialization import init_random_

    cfg = hcodec10_config(causal=True, decoder_dim=64,
                          decoder_intermediate_dim=128,
                          decoder_convnext_layers=2,
                          semantic_encode_channels=64, feat_dim=32)
    gen = torch.Generator(device=card).manual_seed(0)
    with torch.device(card):
        codec = HCodec(cfg, trainable=True)
    init_random_(codec, gen)
    for rvq in (codec.quantizer, codec.semantic_quantizer):
        for layer in rvq.layers:
            layer._codebook.embed.zero_()  # k-means on this batch
    wav = 0.3 * torch.randn(2, 5120, 1, device=card, generator=gen)
    feat = torch.randn(2, 16, 32, device=card, generator=gen)
    searches = []
    search = quant.nearest_code

    def recording(x, codebook):
        codes = search(x, codebook)
        searches.append((x.detach().reshape(-1, x.shape[-1]).float(),
                         codebook.clone(), codes.reshape(-1)))
        return codes

    before = vq.nearest_code.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quant, "nearest_code", recording)
        recon, pred, commit = codec(wav, feat, train=True,
                                    generator=torch.Generator().manual_seed(1))
    n = 2 * cfg.num_quantizers * (quant.KMEANS_ITERS + 2)
    assert len(searches) == n and vq.nearest_code.launches - before == n, (
        len(searches), vq.nearest_code.launches - before, n)
    for x, codebook, codes in searches:
        assert torch.equal(codes, vq.nearest_code_ref(x.contiguous(),
                                                      codebook))
    assert torch.isfinite(recon).all() and torch.isfinite(commit)
