"""HCodec-1.5: an adaptive frame rate by similarity segmentation and
query-token aggregation.

Port of ``unified_audio_tpu/models/hcodec/adaptive.py``:
``similarity_group_ids``, ``group_lengths``, ``degroup``,
``group_ids_from_lengths``, ``inject_length``, ``extract_length``,
``QueryTokenAggregator``, ``AdaptiveConfig``, ``adaptive15_config`` and
``AdaptiveHCodec`` (``encode``, ``decode``, ``token_rate``, the eval
``forward`` and, built with ``trainable``, the training ``forward``).

* Segmentation: a new group starts where the cosine similarity of two
  consecutive semantic frames is at most the threshold, or where the group
  has reached ``max_group_len`` frames. The similarities are computed on
  the device; the (B, T-1) boundary flags cross to the host once, where the
  length rule runs as a loop over T (one sync a call, no launch a frame),
  and the group ids (B, T) go back.
* Aggregation: each group's query token (its mean plus a learned
  ``query_embedding``) is interleaved after the group's last frame in a
  static (B, T + G) buffer, G = T; the Mimi transformer runs over it with
  the padding tail masked out of attention, and the outputs at the query
  positions are the groups (zero rows at the padding groups).
* De-aggregation gathers ``groups[b, group_ids[b, t]]``.
* The length of each group rides in its codes:
  ``code' = (len - 1) * codebook_size + code``, -1 at padding groups.

The groups' residual VQ encode is one K6 launch a stream on a CUDA tensor
(``ops/quant.py ResidualVQ.encode``). Module names follow the reference
layout that ``export_hcodec15_state_dict`` writes
(``acoustic_aggregator.transformer.transformer.layers.{i}``,
``bottleneck_transformer.transformer.layers.{i}``).

``trainable`` builds the training state as the JAX package trains it: the
SEANet encoder's convs as weight norm (g, v) and the EMA residual VQ of
``ops/quant.py`` with the base config's quantizer dropout, run over the
aggregated groups, the padding groups' zero rows included (in k-means, in
the searches and in the EMA counts, as in the JAX package). A causal base
config (``base.causal``) builds the causal SEANet encoder and decoder.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...nn.blocks import SEANetEncoder
from ...nn.mimi import MimiProjectedTransformer
from ...ops.quant import ResidualVQ
from .codec import CodecDecoder10, HCodecConfig, hcodec10_config
from .semantic import SemanticDecoder, SemanticEncoder


def consecutive_similarities(emb):
    """(B, T, D) -> (B, T-1) cosine similarity of consecutive frames, each
    frame over max(|frame|, 1e-8)."""
    norm = emb / torch.clamp(emb.square().sum(-1, keepdim=True).sqrt(),
                             min=1e-8)
    return (norm[:, 1:] * norm[:, :-1]).sum(-1)


def similarity_group_ids(emb, threshold, max_group_len: int = 8):
    """Greedy similarity segmentation of emb (B, T, D) -> group ids (B, T)
    int32, monotone from 0. ``threshold`` is a float or a 0-d tensor."""
    b, t, _ = emb.shape
    new_by_sim = (consecutive_similarities(emb) <= threshold).cpu().numpy()
    boundaries = np.zeros((b, t), np.int32)
    run_len = np.ones(b, np.int64)
    for i in range(t - 1):  # the host scan: at most max_group_len a group
        boundary = new_by_sim[:, i] | (run_len >= max_group_len)
        run_len = np.where(boundary, 1, run_len + 1)
        boundaries[:, i + 1] = boundary
    return torch.as_tensor(np.cumsum(boundaries, axis=1, dtype=np.int32),
                           device=emb.device)


def group_lengths(group_ids, max_groups: int):
    """(B, T) -> (B, G) frames a group (0 at padding groups), int32."""
    return F.one_hot(group_ids.long(), max_groups).sum(1).int()


def degroup(groups, group_ids):
    """Gather groups (B, G, D) back to frames (B, T, D) by group id."""
    idx = group_ids.long()[..., None].expand(-1, -1, groups.shape[-1])
    return torch.gather(groups, 1, idx)


def group_ids_from_lengths(lengths, t: int):
    """Inverse of :func:`group_lengths`: (B, G) -> (B, T) int32."""
    ends = torch.cumsum(lengths.long(), dim=-1).contiguous()
    pos = torch.arange(t, device=lengths.device).expand(lengths.shape[0], t)
    return torch.searchsorted(ends, pos.contiguous(), right=True).int()


def inject_length(codes, lengths, codebook_size: int):
    """code' = (len - 1) * codebook_size + code; padding groups (len 0)
    -> -1. codes (B, G, nq), lengths (B, G)."""
    valid = lengths > 0
    out = (lengths.clamp(min=1) - 1)[..., None] * codebook_size + codes
    return torch.where(valid[..., None], out, -1).int()


def extract_length(codes, codebook_size: int):
    """-> (plain codes, lengths (B, G) from layer 0); -1 stays -1, length
    0."""
    valid = codes >= 0
    lengths = torch.where(valid, codes // codebook_size + 1, 0)
    plain = torch.where(valid, codes % codebook_size, -1)
    return plain, lengths[..., 0]


class QueryTokenAggregator(nn.Module):
    """Interleave one query token after each group's last frame, run the
    Mimi transformer over the static T + G buffer (the tail past T + nG
    masked out of attention), and gather the outputs at the query
    positions. (frames (B, T, D), group ids (B, T)) -> (groups (B, G, D),
    zero at padding groups; counts (B, G) int32), G = T."""

    def __init__(self, dim: int, num_heads: int = 8, num_layers: int = 2,
                 dim_feedforward: int = 2048, context: int = 16):
        super().__init__()
        # the reference stores it (1, D, 1)
        self.query_embedding = nn.Parameter(torch.zeros(1, dim, 1))
        self.transformer = MimiProjectedTransformer(
            dim, dim, dim, num_layers, num_heads, dim_feedforward,
            causal=False, context=context)

    def forward(self, frames, group_ids):
        b, t, d = frames.shape
        g = t  # static max groups
        onehot = F.one_hot(group_ids.long(), g).to(frames.dtype)  # (B, T, G)
        counts = onehot.sum(1)
        valid_g = counts > 0
        ng = valid_g.sum(1)
        means = torch.einsum("btg,btd->bgd", onehot, frames) / torch.clamp(
            counts[..., None], min=1.0)
        queries = means + self.query_embedding.reshape(d)
        # frame t -> t + group_id[t]; query g -> cumsum(counts)[g] + g
        s2 = t + g
        pos = torch.arange(t, device=frames.device)
        frame_dest = pos[None] + group_ids.long()
        cum = torch.cumsum(counts.long(), dim=1)
        query_dest = torch.where(valid_g, cum + pos[None], s2 - 1)
        seq = frames.new_zeros(b, s2, d)
        bidx = torch.arange(b, device=frames.device)[:, None]
        seq[bidx, frame_dest] = frames
        # every padding query writes zeros to slot s2 - 1, which no frame or
        # valid query takes (valid positions lie below t + ng) and attention
        # masks; the duplicate writes carry equal values, so their order
        # (undefined for index_put_ on CUDA) does not matter
        seq[bidx, query_dest] = torch.where(valid_g[..., None], queries, 0.0)
        key_valid = torch.arange(s2, device=frames.device)[None] \
            < (t + ng)[:, None]
        out = self.transformer(seq, key_valid)
        gathered = torch.gather(out, 1, query_dest[..., None].expand(-1, -1,
                                                                      d))
        return gathered * valid_g[..., None], counts.int()


@dataclass(frozen=True)
class AdaptiveConfig:
    """The JAX package's config, field for field. Threshold modes:
    ``fixed`` (``similarity_threshold``), ``dynamic`` (uniform in
    [``threshold_lower``, ``threshold_upper``) a call, from an explicit
    generator); a ``threshold=`` argument overrides both."""

    base: HCodecConfig = field(default_factory=hcodec10_config)
    threshold_mode: str = "fixed"
    similarity_threshold: float = 0.9
    threshold_lower: float = 0.8
    threshold_upper: float = 1.0
    max_group_len: int = 8
    aggregator_layers: int = 32
    aggregator_heads: int = 8
    aggregator_ff: int = 2048
    aggregator_context: int = 16
    bottleneck_layers: int = 32
    bottleneck_dim: int = 0  # 0 -> latent_dim * 2
    bottleneck_heads: int = 8
    bottleneck_ff: int = 2048
    bottleneck_context: int = 16


def adaptive15_config(**kw) -> AdaptiveConfig:
    """The shipped HCodec-1.5 adaptive model: XLSR-53 1024-d features, a
    1024-wide decoder (intermediate 2304), 32-layer aggregators and
    bottleneck, fixed threshold 0.7."""
    base = dict(
        base=hcodec10_config(
            version="1.5", feat_dim=1024, semantic_encode_channels=1024,
            decoder_dim=1024, decoder_intermediate_dim=2304,
            seanet_ratios=(2, 4, 5, 8)),
        similarity_threshold=0.7, threshold_lower=0.7, threshold_upper=1.0,
        max_group_len=8)
    base.update(kw)
    return AdaptiveConfig(**base)


class AdaptiveHCodec(nn.Module):
    """Dual-stream adaptive-rate codec: ``encode(wav (B, L, 1), feat (B,
    2T, feat_dim))`` -> (acoustic, semantic) codes (B, G, nq) with the
    group lengths injected; ``decode`` reverses it. ``trainable`` builds
    the training state (the module docstring); without it the codec is
    the inference model that ``utils/convert.py hcodec15_inference_keys``
    loads."""

    def __init__(self, config: AdaptiveConfig = AdaptiveConfig(),
                 trainable: bool = False):
        super().__init__()
        self.config = config
        self.trainable = trainable
        cfg = config.base
        self.encoder = SEANetEncoder(cfg.latent_dim, cfg.seanet_filters,
                                     cfg.seanet_ratios, weight_norm=trainable,
                                     causal=cfg.causal)
        self.semantic_encoder = SemanticEncoder(
            cfg.feat_dim, cfg.semantic_encode_channels, cfg.latent_dim,
            cfg.semantic_ratios, cfg.semantic_strides)
        self.semantic_decoder = SemanticDecoder(
            cfg.latent_dim, cfg.feat_dim, cfg.semantic_encode_channels,
            cfg.semantic_ratios, cfg.semantic_strides)
        agg = dict(num_heads=config.aggregator_heads,
                   num_layers=config.aggregator_layers,
                   dim_feedforward=config.aggregator_ff,
                   context=config.aggregator_context)
        self.acoustic_aggregator = QueryTokenAggregator(cfg.latent_dim, **agg)
        self.semantic_aggregator = QueryTokenAggregator(cfg.latent_dim, **agg)
        vq = dict(ema=trainable, quantize_dropout=cfg.quantize_dropout)
        self.quantizer = ResidualVQ(cfg.latent_dim, cfg.codebook_size,
                                    cfg.num_quantizers, **vq)
        self.semantic_quantizer = ResidualVQ(cfg.latent_dim,
                                             cfg.codebook_size,
                                             cfg.num_quantizers, **vq)
        width = 2 * cfg.latent_dim
        self.bottleneck_transformer = MimiProjectedTransformer(
            config.bottleneck_dim or width, width, width,
            config.bottleneck_layers, config.bottleneck_heads,
            config.bottleneck_ff, causal=False,
            context=config.bottleneck_context)
        self.decoder = CodecDecoder10(
            width, cfg.decoder_dim, cfg.decoder_intermediate_dim,
            cfg.decoder_convnext_layers, cfg.n_fft, cfg.istft_hop,
            cfg.causal)

    def threshold(self, threshold=None, generator=None):
        """The similarity threshold of a call: ``threshold`` if given, else
        a uniform draw from ``generator`` in the dynamic mode, else the
        config's fixed one."""
        if threshold is not None:
            return threshold
        c = self.config
        if c.threshold_mode == "dynamic":
            dev = generator.device if generator is not None else "cpu"
            u = float(torch.rand((), generator=generator, device=dev))
            return c.threshold_lower + u * (c.threshold_upper
                                            - c.threshold_lower)
        return c.similarity_threshold

    def align(self, wav, feat, threshold=None, generator=None):
        """-> (acoustic groups, semantic groups (B, G, D), group ids (B, T),
        counts (B, G))."""
        emb = self.encoder(wav)
        sem = self.semantic_encoder(feat)
        gid = similarity_group_ids(sem, self.threshold(threshold, generator),
                                   self.config.max_group_len)
        a_groups, counts = self.acoustic_aggregator(emb, gid)
        s_groups, _ = self.semantic_aggregator(sem, gid)
        return a_groups, s_groups, gid, counts

    def forward(self, wav, feat, train: bool = False, threshold=None,
                generator=None):
        """-> (recon (B, L), pred_feat (B, 2T, feat_dim), commit ()): the
        groups quantized layer by layer, de-aggregated, through the
        bottleneck and the decoder. With ``train`` (a ``trainable`` codec)
        the quantizers update their EMA buffers, ``generator`` draws
        k-means' rows, the dropout cutoffs and a dynamic threshold, and
        commit is the mean of each stream's commitment losses."""
        if train and not self.trainable:
            raise ValueError("the training forward needs "
                             "AdaptiveHCodec(trainable=True)")
        a_groups, s_groups, gid, _ = self.align(wav, feat, threshold,
                                                generator)
        qa, _, ca = self.quantizer(a_groups, train, generator)
        qs, _, cs = self.semantic_quantizer(s_groups, train, generator)
        frames = torch.cat([degroup(qa, gid), degroup(qs, gid)], dim=-1)
        recon = self.decoder(self.bottleneck_transformer(frames))
        pred_feat = self.semantic_decoder(degroup(qs, gid))
        return recon, pred_feat, ca.mean() + cs.mean()

    def encode(self, wav, feat, threshold=None, generator=None):
        """-> (acoustic, semantic) codes (B, G, nq), lengths injected; one
        K6 launch a stream on a CUDA tensor."""
        size = self.config.base.codebook_size
        a_groups, s_groups, _, counts = self.align(wav, feat, threshold,
                                                   generator)
        a_codes = self.quantizer.encode(a_groups)
        s_codes = self.semantic_quantizer.encode(s_groups)
        return (inject_length(a_codes, counts, size),
                inject_length(s_codes, counts, size))

    def decode(self, acoustic_codes, semantic_codes):
        """(B, G, nq) length-injected codes -> wav (B, G * hop)."""
        size = self.config.base.codebook_size
        a_plain, lengths = extract_length(acoustic_codes, size)
        s_plain, _ = extract_length(semantic_codes, size)
        gid = group_ids_from_lengths(lengths, acoustic_codes.shape[1])
        frames = torch.cat([degroup(self.quantizer.decode(a_plain), gid),
                            degroup(self.semantic_quantizer.decode(s_plain),
                                    gid)], dim=-1)
        return self.decoder(self.bottleneck_transformer(frames))

    def token_rate(self, wav, feat, threshold=None, generator=None):
        """Groups a second of audio, (B,) fp32."""
        *_, counts = self.align(wav, feat, threshold, generator)
        return (counts > 0).sum(-1).float() / (
            wav.shape[1] / self.config.base.sample_rate)
