"""Weight bridge: the JAX package's variables -> the port's state dicts.

Takes the nested dicts of numpy arrays that ``jax.device_get`` returns for
the JAX package's modules and produces state dicts the port's modules load
with ``load_state_dict`` (numpy values; wrap them with ``torch.as_tensor``).
numpy only: this module imports neither ``jax`` nor ``torch``.

* :func:`llmsft_state_dict`: ``LLMSFT`` variables -> the reference torch
  layout (split q/k/v and gate/up, Linear weights (out, in)), key for key
  what ``utils/convert.py export_custom_llama_state_dict`` writes.
* :func:`unitok_state_dict`: ``UniTokLM`` variables -> the port's
  ``UniTokLM`` (its backbone in the same reference layout).
* :func:`wavlm_state_dict`, :func:`hubert_state_dict` and
  :func:`xlsr_state_dict`: ``Wav2Vec2Model`` (WavLM, HuBERT, XLSR-53)
  variables -> the HF layout, which ``utils/convert.py
  convert_hf_wav2vec2`` maps back.
* :func:`bicodec_decoder_state_dict`: the detokenize subset of
  ``BiCodec`` variables -> the reference layout, key for key what
  ``utils/convert_bicodec.py export_bicodec_state_dict`` writes for those
  modules (weight norm folded). :func:`bicodec_state_dict` adds the
  tokenize side (the feature encoder, the quantizer's ``in_project``, the
  speaker encoder's ECAPA-TDNN with its BatchNorm statistics and
  Perceiver, the FSQ ``project_in``): the whole of what the port's
  ``BiCodec(tokenize=True)`` loads (a full reference state dict also
  holds the postnet and the codebook's usage statistics).
* :func:`hcodec10_state_dict` and :func:`hcodec20_state_dict`: ``HCodec``
  (1.0, 2.0) variables -> the reference layout, key for key what
  ``utils/convert_hcodec.py export_hcodec10_state_dict`` and
  ``export_hcodec20_state_dict`` write (codebooks from the ``codebook``
  collection); :func:`hcodec_inference_keys` keeps the keys the port's
  ``HCodec`` loads, weight norm folded. :func:`hcodec10_train_state_dict`
  and :func:`hcodec20_train_state_dict` give what ``HCodec(trainable=True)``
  loads: weight norm kept as ``weight_g`` (out, 1, 1) and ``weight_v``,
  the codebooks' EMA buffers, the semantic decoder.
* :func:`codec_discriminator_state_dict`: ``CodecDiscriminator`` params
  -> the port's ``CodecDiscriminator`` (Conv2d weights (out, in, kh, kw)).

``nn.scan``-stacked layers are unstacked by indexing their leading axis.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x)


def _linear(p, prefix: str, out: StateDict):
    out[f"{prefix}.weight"] = _a(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _layernorm(p, prefix: str, out: StateDict):
    out[f"{prefix}.weight"] = _a(p["scale"])
    out[f"{prefix}.bias"] = _a(p["bias"])


def _folded(p) -> np.ndarray:
    """Conv params -> (K, in, out) kernel, weight norm folded."""
    if "kernel" in p:
        return _a(p["kernel"])
    v, g = _a(p["kernel_v"]), _a(p["kernel_g"])
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True) + 1e-12)
    return v * (g / norm)


def _conv(p, prefix: str, out: StateDict, unfold: bool = False):
    """Conv params -> ``weight`` (out, in, K), or with ``unfold`` a
    weight-normed conv's ``weight_g`` (out, 1, 1) and ``weight_v``."""
    if unfold and "kernel_v" in p:
        out[f"{prefix}.weight_g"] = _a(p["kernel_g"]).reshape(-1, 1, 1)
        out[f"{prefix}.weight_v"] = _a(p["kernel_v"]).transpose(2, 1, 0)
    else:
        out[f"{prefix}.weight"] = _folded(p).transpose(2, 1, 0)
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _convtr(p, prefix: str, out: StateDict):
    out[f"{prefix}.weight"] = _folded(p).transpose(1, 2, 0)
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return _a(tree)[i]


# ---------------------------------------------------------------------------
# LM (LLMSFT / CodecLM)
# ---------------------------------------------------------------------------

def _backbone(bb, cfg, prefix: str, out: StateDict):
    """``LlamaBackbone`` params (layers stacked on a leading axis, fused
    qkv and gate/up) -> ``{prefix}layers.{i}.*`` and ``{prefix}norm.weight``
    in the reference layout (split q/k/v and gate/up, Linear (out, in))."""
    d = cfg.hidden_size
    out[f"{prefix}norm.weight"] = _a(bb["norm"]["weight"])
    layers = bb["layers"]
    for i in range(cfg.num_layers):
        lp, pre = _index(layers, i), f"{prefix}layers.{i}"
        qkv = lp["self_attn"]["qkv_proj"]["kernel"]
        out[f"{pre}.self_attn.q_proj.weight"] = qkv[:, :d].T
        out[f"{pre}.self_attn.k_proj.weight"] = qkv[:, d:2 * d].T
        out[f"{pre}.self_attn.v_proj.weight"] = qkv[:, 2 * d:].T
        out[f"{pre}.self_attn.o_proj.weight"] = \
            lp["self_attn"]["o_proj"]["kernel"].T
        gate_up = lp["mlp"]["gate_up_proj"]["kernel"]
        inter = gate_up.shape[1] // 2
        out[f"{pre}.mlp.gate_proj.weight"] = gate_up[:, :inter].T
        out[f"{pre}.mlp.up_proj.weight"] = gate_up[:, inter:].T
        out[f"{pre}.mlp.down_proj.weight"] = lp["mlp"]["down_proj"]["kernel"].T
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{pre}.{norm}.weight"] = lp[norm]["weight"]


def llmsft_state_dict(variables, cfg) -> StateDict:
    """LLMSFT (or CodecLM) variables -> reference-layout state dict."""
    p = variables["params"]
    lm = p["lm"]
    sd: StateDict = {
        "codec_embedding.weight": _a(lm["codec_embedding"]["embedding"]),
        "output_head.weight": _a(lm["output_head"]["kernel"]).T,
    }
    _backbone(lm["backbone"], cfg, "", sd)
    if "task_embedding" in p:
        sd["task_embedding.weight"] = _a(p["task_embedding"]["embedding"])
        sd["enroll_sos_embedding.weight"] = _a(p["enroll_sos_embedding"])
        sd["mix_sos_embedding.weight"] = _a(p["mix_sos_embedding"])
        _linear(p["adapter"], "adapter", sd)
    elif "mix_sos_embedding" in p:
        sd["mix_sos_embedding.weight"] = _a(p["mix_sos_embedding"])
    return sd


def unitok_state_dict(variables, cfg) -> StateDict:
    """UniTokLM variables -> the port's ``UniTokLM`` state dict: the
    backbone in the reference layout under ``backbone.``, the task and
    separator tables, the two adapters, and ``code_embeddings.{k}`` /
    ``heads.{k}`` from ``code_embed_{k}`` / ``head_{k}``."""
    p = variables["params"]
    sd: StateDict = {}
    _backbone(p["backbone"], cfg, "backbone.", sd)
    for name in ("task_embedding", "sep_embedding"):
        sd[f"{name}.weight"] = _a(p[name]["embedding"])
    for name in ("text_adapter", "audio_adapter"):
        _linear(p[name], name, sd)
    for k in range(cfg.num_codebooks):
        sd[f"code_embeddings.{k}.weight"] = _a(
            p[f"code_embed_{k}"]["embedding"])
        sd[f"heads.{k}.weight"] = _a(p[f"head_{k}"]["kernel"]).T
    return sd


# ---------------------------------------------------------------------------
# WavLM (HF layout)
# ---------------------------------------------------------------------------

def _wavlm_layer(lp, prefix: str, out: StateDict, use_rel_pos_bias: bool):
    attn = lp["attention"]
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(attn[name], f"{prefix}.attention.{name}", out)
    if use_rel_pos_bias:
        _linear(attn["gru_rel_pos_linear"],
                f"{prefix}.attention.gru_rel_pos_linear", out)
        out[f"{prefix}.attention.gru_rel_pos_const"] = _a(
            attn["gru_rel_pos_const"])
        if "rel_attn_embed" in attn:
            out[f"{prefix}.attention.rel_attn_embed.weight"] = _a(
                attn["rel_attn_embed"])
    _layernorm(lp["layer_norm"], f"{prefix}.layer_norm", out)
    _linear(lp["intermediate_dense"],
            f"{prefix}.feed_forward.intermediate_dense", out)
    _linear(lp["output_dense"], f"{prefix}.feed_forward.output_dense", out)
    _layernorm(lp["final_layer_norm"], f"{prefix}.final_layer_norm", out)


def wavlm_state_dict(variables, cfg) -> StateDict:
    """Wav2Vec2Model variables (WavLM / HuBERT base) -> HF-layout state
    dict; the positional conv weight is the folded ``weight``."""
    p = variables["params"]
    out: StateDict = {}
    fe = p["feature_extractor"]
    for i in range(len(cfg.conv_dim)):
        pre = f"feature_extractor.conv_layers.{i}"
        out[f"{pre}.conv.weight"] = _a(fe[f"conv_{i}_kernel"]).transpose(
            2, 1, 0)
        if f"conv_{i}_bias" in fe:
            out[f"{pre}.conv.bias"] = _a(fe[f"conv_{i}_bias"])
        if f"norm_{i}" in fe:
            _layernorm(fe[f"norm_{i}"], f"{pre}.layer_norm", out)
    _layernorm(p["feature_projection_norm"], "feature_projection.layer_norm",
               out)
    _linear(p["feature_projection"], "feature_projection.projection", out)
    out["encoder.pos_conv_embed.conv.weight"] = _a(
        p["pos_conv_embed"]["kernel"]).transpose(2, 1, 0)
    out["encoder.pos_conv_embed.conv.bias"] = _a(p["pos_conv_embed"]["bias"])
    _layernorm(p["encoder_layer_norm"], "encoder.layer_norm", out)
    _wavlm_layer(p["layers_0"], "encoder.layers.0", out, cfg.use_rel_pos_bias)
    for i in range(1, cfg.num_layers):
        _wavlm_layer(_index(p["layers_rest"]["layer"], i - 1),
                     f"encoder.layers.{i}", out, cfg.use_rel_pos_bias)
    return out


def xlsr_state_dict(variables, cfg) -> StateDict:
    """XLSR-53 variables -> HF-layout state dict: the per-conv LayerNorms
    and conv biases of the extractor, pre-LN layers, and ``encoder.
    layer_norm`` the final LayerNorm."""
    if not cfg.do_stable_layer_norm or cfg.feat_extract_norm != "layer":
        raise ValueError("not an XLSR-53 (stable layer norm) config")
    return wavlm_state_dict(variables, cfg)


def hubert_state_dict(variables, cfg) -> StateDict:
    """HuBERT-base variables -> HF-layout state dict: the WavLM layout
    without the relative-position keys."""
    if cfg.use_rel_pos_bias:
        raise ValueError("HuBERT has no relative position bias; use "
                         "wavlm_state_dict")
    return wavlm_state_dict(variables, cfg)


# ---------------------------------------------------------------------------
# BiCodec decoder (reference layout)
# ---------------------------------------------------------------------------

def _adaln(p, prefix: str, out: StateDict):
    _linear(p["scale"], f"{prefix}.scale", out)
    _linear(p["shift"], f"{prefix}.shift", out)


def _vocos(p, prefix: str, out: StateDict, conditioned: bool = False):
    _conv(p["embed"], f"{prefix}.embed", out)
    norm = _adaln if conditioned else _layernorm
    norm(p["norm"], f"{prefix}.norm", out)
    stacked = p["convnext"]["stack"]["block"]
    for i in range(_a(stacked["dwconv"]["kernel"]).shape[0]):
        block = _index(stacked, i)
        bp = f"{prefix}.convnext.{i}"
        _conv(block["dwconv"], f"{bp}.dwconv", out)
        _linear(block["pwconv1"], f"{bp}.pwconv1", out)
        _linear(block["pwconv2"], f"{bp}.pwconv2", out)
        norm(block["norm"], f"{bp}.norm", out)
        if "gamma" in block:
            out[f"{bp}.gamma"] = _a(block["gamma"])
    _layernorm(p["final_layer_norm"], f"{prefix}.final_layer_norm", out)


def _snake(p, key: str, out: StateDict):
    out[key] = _a(p["alpha"]).transpose(0, 2, 1)  # (1, 1, C) -> (1, C, 1)


def bicodec_decoder_state_dict(variables, cfg) -> StateDict:
    """BiCodec variables -> the state dict of the port's decode-side
    ``BiCodec`` (quantizer decode, speaker detokenize, prenet, decoder)."""
    p = variables["params"]
    out: StateDict = {}
    q = p["quantizer"]
    _conv(q["out_project"], "quantizer.out_project", out)
    out["quantizer.codebook.weight"] = _a(q["codebook"])

    spk = p["speaker_encoder"]
    _linear(spk["quantizer"]["project_out"],
            "speaker_encoder.quantizer.project_out", out)
    _linear(spk["project"], "speaker_encoder.project", out)

    pre = p["prenet"]
    _linear(pre["linear_pre"], "prenet.linear_pre", out)
    for k, ratio in enumerate(cfg.sample_ratios):
        if ratio > 1:
            raise NotImplementedError("only ratio-1 sampling blocks are "
                                      "ported")
        _vocos(pre[f"up_vocos_{k}"], f"prenet.downsample.{k}.1", out)
    _vocos(pre["vocos_backbone"], "prenet.vocos_backbone", out,
           conditioned=True)
    _linear(pre["linear"], "prenet.linear", out)

    w = p["decoder"]
    _conv(w["conv_pre"], "decoder.model.0", out)
    n = len(cfg.wave_rates)
    for i in range(n):
        bp = f"decoder.model.{i + 1}.block"
        blk = w[f"block_{i}"]
        _snake(blk["snake"], f"{bp}.0.alpha", out)
        _convtr(blk["upconv"], f"{bp}.1", out)
        for j in range(3):
            rp = f"{bp}.{j + 2}.block"
            res = blk[f"res_{j}"]
            _snake(res["snake1"], f"{rp}.0.alpha", out)
            _conv(res["conv1"], f"{rp}.1", out)
            _snake(res["snake2"], f"{rp}.2.alpha", out)
            _conv(res["conv2"], f"{rp}.3", out)
    _snake(w["snake_post"], f"decoder.model.{n + 1}.alpha", out)
    _conv(w["conv_post"], f"decoder.model.{n + 2}", out)
    return out


def _batchnorm(p, stats, prefix: str, out: StateDict):
    out[f"{prefix}.weight"] = _a(p["scale"])
    out[f"{prefix}.bias"] = _a(p["bias"])
    out[f"{prefix}.running_mean"] = _a(stats["mean"])
    out[f"{prefix}.running_var"] = _a(stats["var"])


def _conv_relu_bn(p, stats, prefix: str, out: StateDict):
    _conv(p["conv"], f"{prefix}.conv", out)
    _batchnorm(p["bn"], stats["bn"], f"{prefix}.bn", out)


def _ecapa(p, stats, prefix: str, out: StateDict):
    _conv_relu_bn(p["layer1"], stats["layer1"], f"{prefix}.layer1", out)
    for li in (2, 3, 4):
        lp, ls = p[f"layer{li}"], stats[f"layer{li}"]
        pre = f"{prefix}.layer{li}.se_res2block"
        _conv_relu_bn(lp["in_conv"], ls["in_conv"], f"{pre}.0", out)
        n = sum(1 for k in lp["res2"] if k.startswith("conv_"))
        for i in range(n):
            _conv(lp["res2"][f"conv_{i}"], f"{pre}.1.convs.{i}", out)
            _batchnorm(lp["res2"][f"bn_{i}"], ls["res2"][f"bn_{i}"],
                       f"{pre}.1.bns.{i}", out)
        _conv_relu_bn(lp["out_conv"], ls["out_conv"], f"{pre}.2", out)
        _linear(lp["se"]["linear1"], f"{pre}.3.linear1", out)
        _linear(lp["se"]["linear2"], f"{pre}.3.linear2", out)
    _conv(p["conv"], f"{prefix}.conv", out)
    for name in ("linear1", "linear2"):  # Dense -> 1x1 conv (out, in, 1)
        out[f"{prefix}.pool.{name}.weight"] = _a(
            p["pool"][name]["kernel"]).T[:, :, None]
        out[f"{prefix}.pool.{name}.bias"] = _a(p["pool"][name]["bias"])
    _batchnorm(p["bn"], stats["bn"], f"{prefix}.bn", out)
    _linear(p["linear"], f"{prefix}.linear", out)


def _perceiver(p, prefix: str, out: StateDict):
    out[f"{prefix}.latents"] = _a(p["latents"])
    _linear(p["proj_context"], f"{prefix}.proj_context", out)
    out[f"{prefix}.norm.gamma"] = _a(p["norm"]["gamma"])
    depth = sum(1 for k in p if k.startswith("attn_"))
    for i in range(depth):
        for name in ("to_q", "to_kv", "to_out"):
            _linear(p[f"attn_{i}"][name], f"{prefix}.layers.{i}.0.{name}",
                    out)
        _linear(p[f"ff_{i}"]["proj_in"], f"{prefix}.layers.{i}.1.0", out)
        _linear(p[f"ff_{i}"]["proj_out"], f"{prefix}.layers.{i}.1.2", out)


def bicodec_state_dict(variables, cfg) -> StateDict:
    """BiCodec variables ({"params", "batch_stats"}) -> the state dict of
    the port's ``BiCodec(tokenize=True)``: the decode side of
    :func:`bicodec_decoder_state_dict` plus the tokenize side, key for key
    what ``export_bicodec_state_dict`` writes for those modules."""
    p = variables["params"]
    out = bicodec_decoder_state_dict(variables, cfg)
    enc = p["encoder"]
    _vocos(enc["encoder"], "encoder.encoder", out)
    for k, ratio in enumerate(cfg.sample_ratios):
        if ratio > 1:
            raise NotImplementedError("only ratio-1 sampling blocks are "
                                      "ported")
        _vocos(enc[f"down_vocos_{k}"], f"encoder.downsample.{k}.1", out)
    _linear(enc["project"], "encoder.project", out)
    _conv(p["quantizer"]["in_project"], "quantizer.in_project", out)
    spk = p["speaker_encoder"]
    _ecapa(spk["speaker_encoder"],
           variables["batch_stats"]["speaker_encoder"]["speaker_encoder"],
           "speaker_encoder.speaker_encoder", out)
    _perceiver(spk["perceiver_sampler"], "speaker_encoder.perceiver_sampler",
               out)
    _linear(spk["quantizer"]["project_in"],
            "speaker_encoder.quantizer.project_in", out)
    return out


# ---------------------------------------------------------------------------
# HCodec-1.0 (reference layout)
# ---------------------------------------------------------------------------

def _sconv(p, prefix: str, out: StateDict, unfold: bool = False):
    _conv(p, f"{prefix}.conv.conv", out, unfold)


def _hconv(p, prefix: str, out: StateDict):
    _conv(p, f"{prefix}.conv", out)


def _lstm(p, prefix: str, out: StateDict):
    for name, v in p.items():
        if name.startswith("w_"):
            out[f"{prefix}.{name.replace('w_', 'weight_')}"] = _a(v).T
        else:
            out[f"{prefix}.{name.replace('b_', 'bias_')}"] = _a(v)


def _hybrid_transformer(p, prefix: str, out: StateDict):
    for name, layer in p.items():
        lp = f"{prefix}.layers.{name.split('_')[1]}"
        attn = layer["self_attn"]
        _lstm(attn["rnn"], f"{lp}.self_attn.rnn", out)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(attn[proj], f"{lp}.self_attn.{proj}", out)
        for w in ("w1", "w2", "w3"):
            _linear(layer["mlp"][w], f"{lp}.mlp.{w}", out)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{lp}.{norm}.weight"] = _a(layer[norm]["weight"])


def _semantic_branch(p, name: str, strides, out: StateDict):
    first = "conv" if name == "semantic_encoder" else "conv1"
    _hconv(p[first], f"{name}.{first}", out)
    for i, stride in enumerate(strides):
        bp = f"{name}.conv_blocks.{i}"
        block = p[f"block_{i}"]
        if name == "semantic_decoder" and stride > 1:
            _convtr(block["conv"], f"{bp}.conv.deconv", out)
        else:
            _hconv(block["conv"], f"{bp}.conv", out)
        for j in range(2):
            unit, up = block[f"res_{j}"], f"{bp}.res_units.{j}"
            _hconv(unit["conv1"], f"{up}.conv1", out)
            _conv(unit["conv2"], f"{up}.conv2", out)
    _hconv(p["conv2"], f"{name}.conv2", out)


def _rvq(codebooks, prefix: str, out: StateDict):
    for name, layer in codebooks.items():
        pre = f"{prefix}.layers.{name.split('_')[1]}._codebook"
        out[f"{pre}.embed"] = _a(layer["embed"])[None]
        out[f"{pre}.embed_avg"] = _a(layer["embed_avg"])[None]
        out[f"{pre}.cluster_size"] = _a(layer["cluster_size"])[None]
        out[f"{pre}.initted"] = _a(layer["inited"]).reshape(1)


def _resnet_block(p, prefix: str, out: StateDict):
    for norm in ("norm1", "norm2"):
        _layernorm(p[norm], f"{prefix}.{norm}", out)
    for conv in ("conv1", "conv2"):
        _hconv(p[conv], f"{prefix}.{conv}", out)


def _prior_net(pn, prefix: str, out: StateDict):
    for ours, theirs in (("res0", 0), ("res1", 1), ("res2", 5), ("res3", 6)):
        _resnet_block(pn[ours], f"{prefix}.{theirs}", out)
    _hybrid_transformer(pn["transformer"], f"{prefix}.3", out)
    _layernorm(pn["norm_out"], f"{prefix}.7", out)


def _convnext_stack(p, prefix: str, out: StateDict):
    stacked = p["stack"]["block"]
    for i in range(_a(stacked["gamma"]).shape[0]):
        block, bp = _index(stacked, i), f"{prefix}.{i}"
        _hconv(block["dwconv"], f"{bp}.dwconv", out)
        _layernorm(block["norm"], f"{bp}.norm", out)
        _linear(block["pwconv1"], f"{bp}.pwconv1.linear", out)
        _linear(block["pwconv2"], f"{bp}.pwconv2.linear", out)
        out[f"{bp}.gamma"] = _a(block["gamma"])


def _decoder_tail(p, prefix: str, out: StateDict):
    """The decoders' prior net, LayerNorms, ConvNeXt stack and ISTFT head
    (1.0 and 2.0 alike)."""
    _prior_net(p["prior_net"], f"{prefix}.prior_net", out)
    _layernorm(p["norm"], f"{prefix}.norm", out)
    _layernorm(p["final_layer_norm"], f"{prefix}.final_layer_norm", out)
    _linear(p["head"]["out"], f"{prefix}.head.out", out)
    _convnext_stack(p["post_net"], f"{prefix}.post_net", out)


def _codec_decoder10(p, prefix: str, out: StateDict):
    emb = p["embed"]
    out[f"{prefix}.embed.up.weight"] = _a(emb["up_kernel"]).transpose(2, 1, 0)
    out[f"{prefix}.embed.up.bias"] = _a(emb["up_bias"])
    out[f"{prefix}.embed.dw.weight"] = _a(emb["dw_kernel"]).transpose(2, 1, 0)
    out[f"{prefix}.embed.dw.bias"] = _a(emb["bias"])
    _decoder_tail(p, prefix, out)


def _codec_streams(variables, cfg, out: StateDict):
    """Both streams' codebooks and the semantic encoder and decoder."""
    for name in ("quantizer", "semantic_quantizer"):
        _rvq(variables["codebook"][name], name, out)
    for name in ("semantic_encoder", "semantic_decoder"):
        _semantic_branch(variables["params"][name], name,
                         cfg.semantic_strides, out)


def _hcodec10(variables, cfg, unfold: bool) -> StateDict:
    p, out = variables["params"], {}
    enc = p["encoder"]
    _sconv(enc["conv_in"], "encoder.model.0", out, unfold)
    n = len(cfg.seanet_ratios)
    for i in range(n):
        res = enc[f"res_{i}_0"]
        for ours, theirs in (("block_0", "block.1"), ("block_1", "block.3"),
                             ("shortcut", "shortcut")):
            _sconv(res[ours], f"encoder.model.{1 + 3 * i}.{theirs}", out,
                   unfold)
        _sconv(enc[f"down_{i}"], f"encoder.model.{3 + 3 * i}", out, unfold)
    _hybrid_transformer(enc["transformer"], f"encoder.model.{2 + 3 * n}",
                        out)
    _sconv(enc["conv_out"], f"encoder.model.{5 + 3 * n}", out, unfold)
    _codec_streams(variables, cfg, out)
    _codec_decoder10(p["decoder"], "decoder", out)
    return out


def hcodec10_state_dict(variables, cfg) -> StateDict:
    """HCodec-1.0 variables ({"params", "codebook"}) -> the reference
    layout, weight norm folded. The port's ``HCodec`` loads it with
    ``strict=True`` after :func:`hcodec_inference_keys` drops what
    inference does not use."""
    return _hcodec10(variables, cfg, unfold=False)


def hcodec10_train_state_dict(variables, cfg) -> StateDict:
    """HCodec-1.0 variables (``CodecGANTrainer.gen_vars``) -> the state
    dict of the port's ``HCodec(trainable=True)``: the SEANet encoder's
    weight norm as ``weight_g``/``weight_v``, the four codebook buffers,
    the semantic decoder."""
    return _hcodec10(variables, cfg, unfold=True)


def hcodec20_state_dict(variables, cfg) -> StateDict:
    """HCodec-2.0 variables ({"params", "codebook"}) -> the reference
    layout (the encoder's transformer at ``encoder.post_net.1``). The
    port's ``HCodec`` loads it with ``strict=True`` after
    :func:`hcodec_inference_keys` drops what inference does not use."""
    p, out = variables["params"], {}
    enc = p["encoder"]
    _hconv(enc["embed"], "encoder.embed", out)
    _layernorm(enc["norm"], "encoder.norm", out)
    _convnext_stack(enc["prior_net"], "encoder.prior_net", out)
    _hybrid_transformer(enc["post_net"], "encoder.post_net.1", out)
    _layernorm(enc["final_layer_norm"], "encoder.final_layer_norm", out)
    _hconv(enc["out"], "encoder.out", out)
    _hconv(p["decoder"]["embed"], "decoder.embed", out)
    _decoder_tail(p["decoder"], "decoder", out)
    _codec_streams(variables, cfg, out)
    return out


def hcodec20_train_state_dict(variables, cfg) -> StateDict:
    """HCodec-2.0 variables -> the state dict of the port's
    ``HCodec(trainable=True)``. The 2.0 codec has no weight-normed conv,
    so it is :func:`hcodec20_state_dict`, whose codebook buffers and
    semantic decoder training loads."""
    return hcodec20_state_dict(variables, cfg)


def hcodec_inference_keys(sd: StateDict) -> StateDict:
    """The keys the port's inference ``HCodec`` loads: the semantic decoder
    (the training target) and the codebooks' EMA statistics dropped, and
    each ``weight_g``/``weight_v`` pair (a training state dict) folded
    into ``weight`` = g v / sqrt(sum v^2 + 1e-12), the sum over (in, K)
    (numpy values, fp32)."""
    drop = (".embed_avg", ".cluster_size", ".initted")
    out = {}
    for k, v in sd.items():
        if k.startswith("semantic_decoder.") or k.endswith(drop) \
                or k.endswith(".weight_v"):
            continue
        if k.endswith(".weight_g"):
            stem = k[:-len("_g")]
            g = np.asarray(v, np.float32)
            w = np.asarray(sd[stem + "_v"], np.float32)
            norm = np.sqrt((w ** 2).sum(axis=(1, 2), keepdims=True)
                           + np.float32(1e-12))
            out[stem] = w * (g / norm)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Codec GAN discriminators
# ---------------------------------------------------------------------------

def _conv2d(p, prefix: str, out: StateDict):
    out[f"{prefix}.weight"] = _a(p["kernel"]).transpose(3, 2, 0, 1)
    out[f"{prefix}.bias"] = _a(p["bias"])


def codec_discriminator_state_dict(params) -> StateDict:
    """``CodecDiscriminator`` params (``{"params": {"mpd_{p}": ...,
    "stft_{n_fft}": ...}}``) -> the port's ``CodecDiscriminator``: flax's
    (kh, kw, in, out) kernels as (out, in, kh, kw), ``conv_{i}`` at
    ``convs.{i}``."""
    out: StateDict = {}
    for name, sub in params["params"].items():
        for conv, p in sub.items():
            key = (f"convs.{conv.split('_')[1]}" if conv[-1].isdigit()
                   and not conv.startswith("conv_post") else conv)
            _conv2d(p, f"{name}.{key}", out)
    return out
