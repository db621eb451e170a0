"""GAN discriminators and losses of codec training.

Port of ``unified_audio_tpu/train/discriminators.py``: HiFiGAN multi-period
discriminators (``PeriodDiscriminator``) and EnCodec-style multi-resolution
complex-STFT discriminators (``STFTDiscriminator``) in one ensemble
(``CodecDiscriminator``: periods 2, 3, 5, 7, 11; STFTs 1024/256, 2048/512,
512/128), the LSGAN losses, feature matching and the DAC-style multi-scale
log-mel L1.

The JAX package runs flax's ``nn.Conv`` channels-last; here the convs are
``torch.nn.Conv2d`` on NCHW maps, weights (out, in, kh, kw), what
``utils/convert.py codec_discriminator_state_dict`` maps flax's (kh, kw,
in, out) kernels to. A period discriminator's map is (B, 1, T / p, p); an
STFT discriminator's (B, 2 (real, imag), frames, bins). flax's default
``padding="SAME"`` (the STFT discriminators) is TensorFlow's: at stride s
it pads ``max((ceil(n / s) - 1) s + k - n, 0)`` in all, the smaller half
first, which ``padding="same"`` in torch does not do at a stride above 1;
:func:`same_pad` pads explicitly. Scores flatten in (H, W) order, as flax's
(B, H, W, 1) do.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import dsp


def same_pad(x, kernel: Tuple[int, int], stride: Tuple[int, int]):
    """Zero-pad the (H, W) of NCHW ``x`` as TensorFlow's "SAME" does."""
    pads = []
    for n, k, s in zip(x.shape[-2:], kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (h0, h1), (w0, w1) = pads
    return F.pad(x, (w0, w1, h0, h1))


class PeriodDiscriminator(nn.Module):
    """The wav reflect-padded to a multiple of the period and folded into
    (T / p, p), then four (5, 1) convs of stride (3, 1) (32, 128, 512, 1024
    channels), a (5, 1) conv of 1024 and a (3, 1) conv to the score, leaky
    ReLU 0.1 between."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList([
            nn.Conv2d(cin, cout, (5, 1), stride=(3, 1), padding=(2, 0))
            for cin, cout in zip(chans, chans[1:])])
        self.conv_post1 = nn.Conv2d(1024, 1024, (5, 1), padding=(2, 0))
        self.conv_post2 = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, x):
        """x (B, T) -> (scores (B, n), feature maps)."""
        b, t = x.shape
        pad = -t % self.period
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        h = x.reshape(b, 1, -1, self.period)
        feats = []
        for conv in [*self.convs, self.conv_post1]:
            h = F.leaky_relu(conv(h), 0.1)
            feats.append(h)
        score = self.conv_post2(h)
        feats.append(score)
        return score.reshape(b, -1), feats


class STFTDiscriminator(nn.Module):
    """2-D convs over the centered complex STFT (real and imag as two
    channels): four (3, 9) convs of 32 channels, strides (1, 1), then (1,
    2) three times, leaky ReLU 0.1, and a (3, 3) conv to the score; "SAME"
    padding throughout."""

    STRIDES = ((1, 1), (1, 2), (1, 2), (1, 2))

    def __init__(self, n_fft: int, hop_length: int):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        self.convs = nn.ModuleList([
            nn.Conv2d(2 if i == 0 else 32, 32, (3, 9), stride=s)
            for i, s in enumerate(self.STRIDES)])
        self.conv_post = nn.Conv2d(32, 1, (3, 3))

    def forward(self, x):
        """x (B, T) -> (scores (B, n), feature maps)."""
        spec = dsp.stft(x, self.n_fft, self.hop_length, center=True)
        h = torch.stack([spec.real, spec.imag], 1).transpose(2, 3)
        feats = []
        for conv, stride in zip(self.convs, self.STRIDES):
            h = F.leaky_relu(conv(same_pad(h, (3, 9), stride)), 0.1)
            feats.append(h)
        score = self.conv_post(same_pad(h, (3, 3), (1, 1)))
        feats.append(score)
        return score.reshape(x.shape[0], -1), feats


class CodecDiscriminator(nn.Module):
    """The ensemble: ``mpd_{p}`` for each period, then ``stft_{n_fft}``
    for each resolution. x (B, T) -> (scores, feature maps), a list of
    each."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 stft_resolutions: Sequence[Tuple[int, int]] = (
                     (1024, 256), (2048, 512), (512, 128))):
        super().__init__()
        self.names = []
        for p in periods:
            self.add_module(f"mpd_{p}", PeriodDiscriminator(p))
            self.names.append(f"mpd_{p}")
        for n_fft, hop in stft_resolutions:
            self.add_module(f"stft_{n_fft}", STFTDiscriminator(n_fft, hop))
            self.names.append(f"stft_{n_fft}")

    def forward(self, x):
        scores, feats = [], []
        for name in self.names:
            s, f = getattr(self, name)(x)
            scores.append(s)
            feats.append(f)
        return scores, feats


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def discriminator_loss(real_scores, fake_scores):
    """LSGAN: mean over the discriminators of mean((1 - real)^2) +
    mean(fake^2)."""
    loss = 0.0
    for r, f in zip(real_scores, fake_scores):
        loss = loss + (1.0 - r).square().mean() + f.square().mean()
    return loss / len(real_scores)


def generator_adversarial_loss(fake_scores):
    """LSGAN: mean over the discriminators of mean((1 - fake)^2)."""
    loss = 0.0
    for f in fake_scores:
        loss = loss + (1.0 - f).square().mean()
    return loss / len(fake_scores)


def feature_matching_loss(real_feats, fake_feats):
    """Mean over every feature map of mean |real - fake|, the real side a
    constant target (detached)."""
    loss, n = 0.0, 0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            loss = loss + (r.detach() - f).abs().mean()
            n += 1
    return loss / max(n, 1)


def multiscale_mel_loss(real, fake, sample_rate: int = 16000,
                        n_ffts: Sequence[int] = (32, 64, 128, 256, 512, 1024,
                                                 2048),
                        n_mels: int = 80):
    """Mean over the scales of mean |log(mel(real) + 1e-5) - log(mel(fake)
    + 1e-5)|; real, fake (B, T). A scale's STFT is n_fft wide with hop
    n_fft / 4 and min(n_mels, n_fft / 2) slaney mels up to sr / 2."""
    loss = 0.0
    for n_fft in n_ffts:
        hop, mels = n_fft // 4, min(n_mels, n_fft // 2)
        mr, mf = (dsp.mel_spectrogram(x, sample_rate, n_fft, n_fft, hop, 0.0,
                                      sample_rate / 2, mels)
                  for x in (real, fake))
        loss = loss + ((mr + 1e-5).log() - (mf + 1e-5).log()).abs().mean()
    return loss / len(n_ffts)
