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
    export_hcodec10_state_dict, export_hcodec20_state_dict)
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
