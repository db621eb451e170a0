"""The weight bridge (``unified_audio_tpu_torch.utils.convert``) against the
JAX package's own exporters and converters, key for key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (jax_sft, random_variables, tiny_lm_config,
                               to_torch)
from unified_audio_tpu.models.bicodec.bicodec import BiCodec, BiCodecConfig
from unified_audio_tpu.models.ssl import wav2vec2 as j_ssl
from unified_audio_tpu.utils.convert import (convert_hf_wav2vec2,
                                             export_custom_llama_state_dict)
from unified_audio_tpu.utils.convert_bicodec import export_bicodec_state_dict
from unified_audio_tpu.utils.convert_hcodec import (
    export_hcodec10_state_dict, export_hcodec15_state_dict,
    export_hcodec20_state_dict)
from unified_audio_tpu_torch.models.bicodec import bicodec as t_bicodec
from unified_audio_tpu_torch.models.hcodec import codec as t_codec
from unified_audio_tpu_torch.utils import convert as t_convert


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_llmsft_matches_reference_exporter():
    cfg = tiny_lm_config()
    _, variables = jax_sft(cfg, feats_dim=12)
    _assert_same(t_convert.llmsft_state_dict(variables, cfg),
                 export_custom_llama_state_dict(variables, cfg))


def test_bicodec_decoder_matches_reference_exporter():
    """Every key the port's decoder loads is exported identically by
    export_bicodec_state_dict, and the port's module takes exactly them."""
    cfg = BiCodecConfig(
        ref_segment_duration=0.2, feat_dim=32, vocos_dim=32,
        vocos_intermediate_dim=64, vocos_num_layers=2, latent_dim=32,
        codebook_size=64, codebook_dim=8, spk_out_dim=32, spk_latent_dim=16,
        token_num=4, fsq_levels=(4, 4, 4), num_mels=32, mel_n_fft=256,
        mel_win=160, mel_hop=80, wave_channels=32,
        wave_rates=(8, 5, 4, 2), wave_kernels=(16, 11, 8, 4))
    variables = random_variables(BiCodec(cfg), np.zeros((1, 10, 32),
                                                        np.float32),
                                 np.zeros((1, 3200), np.float32))
    ours = t_convert.bicodec_decoder_state_dict(variables, cfg)
    ref = export_bicodec_state_dict(variables, cfg)
    _assert_same(ours, {k: ref[k] for k in ours})
    module = t_bicodec.BiCodec(t_bicodec.BiCodecConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    assert sorted(module.state_dict()) == sorted(ours)
    module.load_state_dict(to_torch(ours))


@pytest.mark.parametrize("rel_pos", [True, False])
def test_wavlm_inverts_hf_converter(rel_pos):
    """convert_hf_wav2vec2 maps the port's HF-layout state dict back to the
    JAX variables, leaf for leaf."""
    cfg = j_ssl.SSLConfig(
        hidden_size=24, num_layers=3, num_heads=4, intermediate_size=32,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, use_rel_pos_bias=rel_pos,
        num_buckets=32, max_distance=80)
    variables = random_variables(j_ssl.Wav2Vec2Model(cfg),
                                 np.zeros((1, 3200), np.float32))
    sd = t_convert.wavlm_state_dict(variables, cfg)
    back = convert_hf_wav2vec2(to_torch(sd), cfg)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_hcodec10_matches_reference_exporter():
    """hcodec10_state_dict == export_hcodec10_state_dict key for key and
    value for value (codebooks from the ``codebook`` collection, the
    ConvNeXt stack unstacked per block), and the port's HCodec takes
    exactly its inference keys with strict loading."""
    from unified_audio_tpu.models.hcodec.codec import HCodec, hcodec10_config

    cfg = hcodec10_config(
        latent_dim=64, seanet_filters=4, codebook_size=32, num_quantizers=2,
        decoder_dim=64, decoder_intermediate_dim=128,
        decoder_convnext_layers=3, semantic_encode_channels=64, feat_dim=32)
    variables = jax.device_get(random_variables(
        HCodec(cfg), np.zeros((1, 640 * 4, 1), np.float32),
        np.zeros((1, 8, 32), np.float32)))
    ours = t_convert.hcodec10_state_dict(variables, cfg)
    _assert_same(ours, export_hcodec10_state_dict(variables, cfg))
    keys = t_convert.hcodec_inference_keys(ours)
    assert not any(k.startswith("semantic_decoder.") or "embed_avg" in k
                   for k in keys)
    module = t_codec.HCodec(t_codec.HCodecConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    assert sorted(module.state_dict()) == sorted(keys)
    module.load_state_dict(to_torch(keys))


def test_hcodec20_matches_reference_exporter():
    """hcodec20_state_dict == export_hcodec20_state_dict key for key and
    value for value (the encoder's transformer at ``post_net.1``, both
    ConvNeXt stacks unstacked per block), and the port's HCodec-2.0 takes
    exactly its inference keys with strict loading."""
    from unified_audio_tpu.models.hcodec.codec import HCodec, hcodec20_config

    cfg = hcodec20_config(
        latent_dim=64, codebook_size=32, num_quantizers=3, decoder_dim=64,
        decoder_intermediate_dim=128, decoder_convnext_layers=2,
        encoder_dim=64, encoder_intermediate_dim=128,
        encoder_convnext_layers=3, semantic_encode_channels=64, feat_dim=32)
    variables = jax.device_get(random_variables(
        HCodec(cfg), np.zeros((1, 3840 * 2, 1), np.float32),
        np.zeros((1, 8, 32), np.float32)))
    ours = t_convert.hcodec20_state_dict(variables, cfg)
    _assert_same(ours, export_hcodec20_state_dict(variables, cfg))
    keys = t_convert.hcodec_inference_keys(ours)
    assert not any(k.startswith("semantic_decoder.") or "embed_avg" in k
                   for k in keys)
    module = t_codec.HCodec(t_codec.HCodecConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}))
    assert sorted(module.state_dict()) == sorted(keys)
    module.load_state_dict(to_torch(keys))
    assert "encoder.post_net.1.layers.0.self_attn.q_proj.weight" in keys


def test_hubert_state_dict_has_no_rel_pos_keys():
    cfg = j_ssl.SSLConfig(
        hidden_size=24, num_layers=2, num_heads=4, intermediate_size=32,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4)
    variables = random_variables(j_ssl.Wav2Vec2Model(cfg),
                                 np.zeros((1, 3200), np.float32))
    sd = t_convert.hubert_state_dict(variables, cfg)
    assert not any("rel" in k for k in sd)
    with pytest.raises(ValueError):
        t_convert.hubert_state_dict(variables, j_ssl.wavlm_base_plus_config())


def _unitok():
    from test_torch_unitok import tiny_cfg
    from unified_audio_tpu.models.unitok.model import UniTokLM

    cfg = tiny_cfg()
    jlm = UniTokLM(cfg)
    variables = jax.device_get(random_variables(
        jlm, 0, np.zeros((1, 3, cfg.text_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 4, cfg.audio_dim), np.float32),
        np.zeros((1, 6, cfg.num_codebooks), np.int32), seed=7))
    return cfg, jlm, variables


def test_unitok_state_dict_key_for_key():
    """The backbone's keys and values are what the JAX package's LM exporter
    writes for the same decoder stack; every other key is its JAX leaf
    (Linear kernels transposed); the port's UniTokLM takes exactly these
    keys with strict loading."""
    from test_torch_unitok import port_unitok

    cfg, _, variables = _unitok()
    p = variables["params"]
    sd = t_convert.unitok_state_dict(variables, cfg)
    d = cfg.hidden_size
    as_lm = {"params": {"lm": {
        "backbone": p["backbone"],
        "codec_embedding": {"embedding": np.zeros((1, d), np.float32)},
        "output_head": {"kernel": np.zeros((d, 1), np.float32)}}}}
    ref = {f"backbone.{k}": v for k, v in export_custom_llama_state_dict(
        as_lm, cfg.llama_config).items()
        if k.startswith(("layers.", "norm."))}
    for name in ("task_embedding", "sep_embedding"):
        ref[f"{name}.weight"] = p[name]["embedding"]
    for name in ("text_adapter", "audio_adapter"):
        ref[f"{name}.weight"] = np.asarray(p[name]["kernel"]).T
        ref[f"{name}.bias"] = p[name]["bias"]
    for k in range(cfg.num_codebooks):
        ref[f"code_embeddings.{k}.weight"] = p[f"code_embed_{k}"]["embedding"]
        ref[f"heads.{k}.weight"] = np.asarray(p[f"head_{k}"]["kernel"]).T
    _assert_same(sd, ref)
    assert sorted(port_unitok(cfg, variables).state_dict()) == sorted(sd)


def test_unitok_forward_matches_jax():
    """Teacher-forced forward, as the JAX ``UniTokLM.__call__`` runs it
    (prompt, BOS + delayed codes, backbone, K heads): the port's logits
    within atol/rtol 1e-4 of JAX's, caption, reference and input present."""
    from test_torch_unitok import port_unitok
    from unified_audio_tpu.models.unitok.delay import apply_delay as j_delay
    from unified_audio_tpu_torch.models.lm.llama import init_cache
    from unified_audio_tpu_torch.models.unitok.delay import apply_delay

    cfg, jlm, variables = _unitok()
    tlm = port_unitok(cfg, variables)
    rng = np.random.default_rng(8)
    cap = rng.standard_normal((2, 3, cfg.text_dim)).astype(np.float32)
    ref = rng.standard_normal((2, 5, cfg.audio_dim)).astype(np.float32)
    inp = rng.standard_normal((2, 4, cfg.audio_dim)).astype(np.float32)
    codes = rng.integers(0, cfg.codebook_size, (2, 6, cfg.num_codebooks))
    k = cfg.num_codebooks

    def j_logits(m, cap, ref, inp, codes):
        delayed = j_delay(codes, cfg.pad)
        bos = jnp.full((2, 1, k), cfg.bos, delayed.dtype)
        inputs = jnp.concatenate([bos, delayed], axis=1)[:, :-1]
        prompt = m.build_prompt(3, cap, ref, inp, 2)
        embeds = jnp.concatenate([prompt, m.embed_codes(inputs)], 1)
        hidden = m.backbone(embeds)[:, -inputs.shape[1]:]
        return jnp.stack([m.heads[kk](hidden) for kk in range(k)], 2)

    want = jlm.apply(variables, cap, ref, inp, codes.astype(np.int32),
                     method=j_logits)
    with torch.no_grad():
        delayed = apply_delay(torch.as_tensor(codes), cfg.pad)
        inputs = torch.cat([torch.full((2, 1, k), cfg.bos), delayed],
                           1)[:, :-1]
        prompt = tlm.build_prompt(3, *map(torch.as_tensor, (cap, ref, inp)),
                                  2)
        embeds = torch.cat([prompt, tlm.embed_codes(inputs)], 1)
        cache = init_cache(tlm.lcfg, 2, embeds.shape[1])
        hidden, _ = tlm.backbone.cached_forward(embeds, cache)
        hidden = hidden[:, -inputs.shape[1]:]
        got = torch.stack([h(hidden) for h in tlm.heads], 2)
    assert got.shape == (2, 6 + k - 1, k, cfg.layer_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _tagged(tree):
    """``tree`` with every entry replaced by its own index (float64)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out, start = [], 0
    for leaf in leaves:
        n = int(np.size(leaf))
        out.append(np.arange(start, start + n, dtype=np.float64).reshape(
            np.shape(leaf)))
        start += n
    return jax.tree_util.tree_unflatten(treedef, out), start


def _covers_once(sd, n):
    tags = np.sort(np.concatenate([np.asarray(v).ravel() for v in sd.values()]))
    np.testing.assert_array_equal(tags, np.arange(n, dtype=np.float64))


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_hcodec_train_state_dict_carries_every_leaf(version):
    """``hcodec10_train_state_dict`` / ``hcodec20_train_state_dict`` put
    every entry of every JAX leaf (the params, weight norm unfolded as
    ``weight_g`` (out, 1, 1) and ``weight_v``; the ``codebook``
    collection's embed, embed_avg, cluster_size and inited; the semantic
    decoder) in exactly one place, and ``HCodec(trainable=True)`` takes
    exactly those keys with strict loading."""
    from unified_audio_tpu.models.hcodec.codec import (HCodec, hcodec10_config,
                                                       hcodec20_config)

    small = dict(latent_dim=64, codebook_size=32, num_quantizers=2,
                 decoder_dim=64, decoder_intermediate_dim=128,
                 decoder_convnext_layers=2, semantic_encode_channels=64,
                 feat_dim=32)
    if version == "1.0":
        cfg, n = hcodec10_config(seanet_filters=4, **small), 640 * 4
        export = t_convert.hcodec10_train_state_dict
    else:
        cfg, n = hcodec20_config(encoder_dim=64, encoder_intermediate_dim=128,
                                 encoder_convnext_layers=2, **small), 3840 * 2
        export = t_convert.hcodec20_train_state_dict
    variables = jax.device_get(random_variables(
        HCodec(cfg), np.zeros((1, n, 1), np.float32),
        np.zeros((1, 8, 32), np.float32)))
    tagged, total = _tagged(variables)
    _covers_once(export(tagged, cfg), total)
    ours = export(variables, cfg)
    n_g = sum(1 for path, _ in jax.tree_util.tree_flatten_with_path(
        variables)[0] if path[-1].key == "kernel_g")
    assert sum(k.endswith(".weight_g") for k in ours) == n_g
    assert (n_g > 0) == (version == "1.0")
    for k in ours:
        if k.endswith(".weight_g"):
            assert ours[k].shape[1:] == (1, 1)
    assert any(k.startswith("semantic_decoder.") for k in ours)
    for buf in ("embed", "embed_avg", "cluster_size", "initted"):
        assert sum(k.endswith(f"._codebook.{buf}") for k in ours) == \
            2 * cfg.num_quantizers
    module = t_codec.HCodec(t_codec.HCodecConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
        trainable=True)
    assert sorted(module.state_dict()) == sorted(ours)
    module.load_state_dict(to_torch(ours))


def test_codec_discriminator_state_dict_carries_every_leaf():
    """``codec_discriminator_state_dict`` puts every entry of a
    ``CodecDiscriminator``'s params in exactly one place, with the port's
    keys and shapes, for a small ensemble (values) and the default one
    (every conv of the 5 period and 3 STFT discriminators, shapes)."""
    from unified_audio_tpu.train.discriminators import CodecDiscriminator
    from unified_audio_tpu_torch.train import discriminators as t_disc

    small = dict(periods=(2, 3), stft_resolutions=((256, 64),))
    x = np.zeros((1, 2048, 1), np.float32)
    params = random_variables(CodecDiscriminator(**small), x)
    tagged, total = _tagged(params)
    _covers_once(t_convert.codec_discriminator_state_dict(tagged), total)
    t_disc.CodecDiscriminator(**small).load_state_dict(to_torch(
        t_convert.codec_discriminator_state_dict(params)))
    shapes = jax.eval_shape(lambda: CodecDiscriminator().init(
        jax.random.PRNGKey(0), x))
    empty = jax.tree_util.tree_map(lambda s: np.empty(s.shape, s.dtype),
                                   shapes)
    sd = t_convert.codec_discriminator_state_dict(empty)
    with torch.device("meta"):
        want = t_disc.CodecDiscriminator().state_dict()
    assert sorted(sd) == sorted(want)
    assert len(sd) == 2 * (5 * 6 + 3 * 5)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_raw_weight_norm_checkpoint_codes_equal_folded(tmp_path,
                                                        monkeypatch):
    """``cli codec --ckpt`` on a raw training state dict (``weight_g`` /
    ``weight_v``, EMA buffers, semantic decoder; what ``train-codec``
    saves under "gen") and on its folded twin (``hcodec10_state_dict``)
    gives the same codes and the same waveform within 1e-6 of its peak."""
    import dataclasses
    import functools

    from test_torch_hcodec import L, _wav, small10, tiny_hubert
    from unified_audio_tpu.models.hcodec.codec import HCodec
    from unified_audio_tpu_torch import cli
    from unified_audio_tpu_torch.data.audio_io import write_wav
    from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl

    cfg = small10()
    variables = jax.device_get(random_variables(
        HCodec(cfg), np.zeros((1, L, 1), np.float32),
        np.zeros((1, L // 320, 32), np.float32), seed=7))
    monkeypatch.setattr(cli, "_build_hcodec", functools.partial(
        cli._build_hcodec, cfg=t_codec.HCodecConfig(
            **dataclasses.asdict(cfg)),
        ssl_cfg=t_ssl.SSLConfig(**dataclasses.asdict(tiny_hubert()))))
    seen, wavs = [], []
    encode = t_codec.HCodec.encode
    monkeypatch.setattr(t_codec.HCodec, "encode", lambda self, w, f: (
        seen.append(encode(self, w, f)) or seen[-1]))
    monkeypatch.setattr(cli, "write_wav", lambda *a: wavs.append(a[1]))
    write_wav(tmp_path / "in.wav", _wav(3)[0], 16000)
    for name, export in (("raw", t_convert.hcodec10_train_state_dict),
                         ("folded", t_convert.hcodec10_state_dict)):
        ckpt = tmp_path / f"{name}.pt"
        torch.save({"gen": to_torch(export(variables, cfg))}, ckpt)
        cli.main(["codec", "--model", "hcodec10", "--input",
                  str(tmp_path / "in.wav"), "--output",
                  str(tmp_path / "o.wav"), "--ckpt", str(ckpt), "--device",
                  "cpu"])
    (a0, s0), (a1, s1) = seen
    assert torch.equal(a0, a1) and torch.equal(s0, s1)
    assert np.abs(wavs[0] - wavs[1]).max() <= 1e-6 * np.abs(wavs[1]).max()


def _unfolded(sd, keep, names=("weight_g", "weight_v"), dim=0):
    """``sd`` with each conv weight whose key passes ``keep`` split into a
    weight-norm pair: v twice the weight, g its norm over every axis but
    ``dim`` (0: a conv's out channels; a transposed conv's in channels)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and np.ndim(v) == 3 and keep(k):
            w = np.asarray(v, np.float32)
            axes = tuple(i for i in range(3) if i != dim)
            stem = k[:-len("weight")]
            out[stem + names[0]] = np.sqrt((w ** 2).sum(axes, keepdims=True))
            out[stem + names[1]] = 2.0 * w
        else:
            out[k] = v
    return out


def _assert_folds_back(sd, folded):
    assert sorted(folded) == sorted(sd)
    for k in sd:
        np.testing.assert_allclose(np.asarray(folded[k]), np.asarray(sd[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_hcodec15_reference_layout():
    """The port's AdaptiveHCodec takes exactly the keys of
    export_hcodec15_state_dict (the SEANet encoder, aggregators,
    bottleneck, both codebooks, the semantic encoder and decoder, the
    decoder) with the EMA statistics dropped, strictly; the JAX package's
    convert_hcodec15 reads the same file back to the same variables; a
    weight-norm (g, v) twin of the SEANet convs folds to the same
    weights."""
    import dataclasses

    from test_torch_hcodec import small10
    from unified_audio_tpu.models.hcodec import adaptive as j_adaptive
    from unified_audio_tpu.utils.convert_hcodec import convert_hcodec15
    from unified_audio_tpu_torch.models.hcodec import adaptive as t_adaptive

    cfg = j_adaptive.AdaptiveConfig(
        base=small10(), aggregator_layers=2, aggregator_ff=64,
        bottleneck_layers=3, bottleneck_ff=64)
    variables = jax.device_get(random_variables(
        j_adaptive.AdaptiveHCodec(cfg), np.zeros((1, 640 * 4, 1), np.float32),
        np.zeros((1, 8, 32), np.float32)))
    sd = export_hcodec15_state_dict(variables, cfg)
    keys = t_convert.hcodec15_inference_keys(sd)
    assert not any(k.endswith(("embed_avg", "cluster_size", "initted"))
                   for k in keys)
    module = t_adaptive.AdaptiveHCodec(t_adaptive.AdaptiveConfig(
        base=t_codec.HCodecConfig(**dataclasses.asdict(cfg.base)),
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "base"}))
    assert sorted(module.state_dict()) == sorted(keys)
    module.load_state_dict(to_torch(keys))
    assert "bottleneck_transformer.transformer.layers.2.self_attn." \
        "in_proj_weight" in keys
    assert keys["acoustic_aggregator.query_embedding"].shape == (1, 64, 1)
    back = convert_hcodec15(sd, cfg)
    np.testing.assert_array_equal(
        back["params"]["acoustic_aggregator"]["query_embedding"],
        variables["params"]["acoustic_aggregator"]["query_embedding"])
    raw = _unfolded(sd, lambda k: k.startswith("encoder.model."))
    assert any(k.endswith("weight_v") for k in raw)
    _assert_folds_back(keys, t_convert.hcodec15_inference_keys(raw))


@pytest.mark.parametrize("aligned", [False, True])
def test_flexicodec_reference_layout(aligned):
    """The port's FlexiCodec takes exactly the keys of
    export_flexicodec_state_dict (``dac.*``, the ConvNeXt adapters without
    gamma, ``semantic_vq.fsq.*``, and in the aligned mode the aggregators
    and the bottleneck), strictly; weight-norm twins of the DAC and
    adapter convs, in the legacy names and in torch's parametrization
    names (the transposed convs normed per input channel), fold to the
    same weights."""
    import dataclasses

    from test_torch_flexicodec import aligned_cfg, tiny_cfg
    from unified_audio_tpu.models.hcodec.flexicodec import FlexiCodec
    from unified_audio_tpu.utils.convert_hcodec import (
        export_flexicodec_state_dict)
    from unified_audio_tpu_torch.models.hcodec import flexicodec as t_flexi

    cfg = aligned_cfg() if aligned else tiny_cfg()
    variables = jax.device_get(random_variables(
        FlexiCodec(cfg), np.zeros((1, 512 * 4), np.float32),
        np.zeros((1, 8, cfg.ssl_dim), np.float32)))
    sd = export_flexicodec_state_dict(variables, cfg)
    keys = t_convert.flexicodec_inference_keys(sd)
    module = t_flexi.FlexiCodec(t_flexi.FlexiCodecConfig(
        **dataclasses.asdict(cfg)))
    assert sorted(module.state_dict()) == sorted(keys)
    module.load_state_dict(to_torch(keys))
    assert ("semantic_aggregator.query_embedding" in keys) == aligned
    upconv = "dac.decoder.model.1.block.1.weight"
    for names in (("weight_g", "weight_v"),
                  ("parametrizations.weight.original0",
                   "parametrizations.weight.original1")):
        raw = _unfolded({k: v for k, v in sd.items() if k != upconv},
                        lambda k: k.startswith(("dac.", "convnext_")),
                        names)
        raw.update(_unfolded({upconv: sd[upconv]}, lambda k: True, names,
                             dim=0))
        assert any(k.endswith(names[1]) for k in raw)
        _assert_folds_back(keys, t_convert.flexicodec_inference_keys(raw))
