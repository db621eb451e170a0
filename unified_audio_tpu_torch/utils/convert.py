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
  the codebooks' EMA buffers, the semantic decoder. A causal HCodec has
  the same parameters, so the same functions serve it.
* :func:`hcodec15_train_state_dict` and :func:`flexicodec_train_state_dict`:
  HCodec-1.5's and FlexiCodec's JAX training variables -> what
  ``AdaptiveHCodec(trainable=True)`` and ``FlexiCodec(trainable=True)``
  load (weight norm kept, the EMA buffers).
* :func:`fold_weight_norm` folds ``weight_g``/``weight_v`` pairs;
  :func:`hcodec15_inference_keys` and :func:`flexicodec_inference_keys`
  take the reference HCodec-1.5 and FlexiCodec layouts (what
  ``export_hcodec15_state_dict`` and ``export_flexicodec_state_dict``
  write) to the port's ``AdaptiveHCodec`` and ``FlexiCodec``;
  :func:`sensevoice_keys` takes funasr's SenseVoiceSmall layout (what
  ``convert_sensevoice`` reads) to ``SenseVoiceSemanticEncoder``.
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


def _convtr(p, prefix: str, out: StateDict, unfold: bool = False):
    """Transposed-conv params -> ``weight`` (in, out, K), or with
    ``unfold`` a weight-normed one's ``weight_g`` (1, out, 1) and
    ``weight_v``."""
    if unfold and "kernel_v" in p:
        out[f"{prefix}.weight_g"] = _a(p["kernel_g"]).reshape(1, -1, 1)
        out[f"{prefix}.weight_v"] = _a(p["kernel_v"]).transpose(1, 2, 0)
    else:
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
    if "out_project" in q:  # none when input_dim == codebook_dim
        _conv(q["out_project"], "quantizer.out_project", out)
    out["quantizer.codebook.weight"] = _a(q["codebook"])

    spk = p["speaker_encoder"]
    if "project_out" in spk.get("quantizer", {}):  # none: dim == len(levels)
        _linear(spk["quantizer"]["project_out"],
                "speaker_encoder.quantizer.project_out", out)
    _linear(spk["project"], "speaker_encoder.project", out)

    pre = p["prenet"]
    _linear(pre["linear_pre"], "prenet.linear_pre", out)
    for k, ratio in enumerate(cfg.sample_ratios):
        if ratio > 1:
            _sampling(pre[f"up_{k}"], f"prenet.downsample.{k}.0", out)
        _vocos(pre[f"up_vocos_{k}"], f"prenet.downsample.{k}.1", out)
    _vocos(pre["vocos_backbone"], "prenet.vocos_backbone", out,
           conditioned=True)
    _linear(pre["linear"], "prenet.linear", out)

    _wave_generator(p["decoder"], "decoder", len(cfg.wave_rates), out)
    return out


def _sampling(p, prefix: str, out: StateDict):
    """A ``SamplingBlock`` above ratio 1: its grouped transposed conv
    (JAX (K, 1, C) -> torch (C, 1, K), the layout of a grouped conv's
    kernel) or strided conv, at ``de_conv_upsampler.1`` /
    ``conv_downsampler.1``."""
    for name in ("de_conv_upsampler", "conv_downsampler"):
        if name in p:
            _conv(p[name], f"{prefix}.{name}.1", out)


def _dac_residual_unit(res, prefix: str, out: StateDict, unfold: bool):
    _snake(res["snake1"], f"{prefix}.block.0.alpha", out)
    _conv(res["conv1"], f"{prefix}.block.1", out, unfold)
    _snake(res["snake2"], f"{prefix}.block.2.alpha", out)
    _conv(res["conv2"], f"{prefix}.block.3", out, unfold)


def _wave_generator(w, prefix: str, n: int, out: StateDict,
                    unfold: bool = False):
    """``WaveGenerator`` params of ``n`` upsampling blocks ->
    ``{prefix}.model.{i}`` (weight norm folded, or kept with ``unfold``)."""
    _conv(w["conv_pre"], f"{prefix}.model.0", out, unfold)
    for i in range(n):
        bp = f"{prefix}.model.{i + 1}.block"
        blk = w[f"block_{i}"]
        _snake(blk["snake"], f"{bp}.0.alpha", out)
        _convtr(blk["upconv"], f"{bp}.1", out, unfold)
        for j in range(3):
            _dac_residual_unit(blk[f"res_{j}"], f"{bp}.{j + 2}", out, unfold)
    _snake(w["snake_post"], f"{prefix}.model.{n + 1}.alpha", out)
    _conv(w["conv_post"], f"{prefix}.model.{n + 2}", out, unfold)


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
    if "proj_context" in p:  # none when dim_context == dim
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
            _sampling(enc[f"down_{k}"], f"encoder.downsample.{k}.0", out)
        _vocos(enc[f"down_vocos_{k}"], f"encoder.downsample.{k}.1", out)
    _linear(enc["project"], "encoder.project", out)
    if "in_project" in p["quantizer"]:
        _conv(p["quantizer"]["in_project"], "quantizer.in_project", out)
    spk = p["speaker_encoder"]
    _ecapa(spk["speaker_encoder"],
           variables["batch_stats"]["speaker_encoder"]["speaker_encoder"],
           "speaker_encoder.speaker_encoder", out)
    _perceiver(spk["perceiver_sampler"], "speaker_encoder.perceiver_sampler",
               out)
    if "project_in" in spk.get("quantizer", {}):
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


def _mlp(p, prefix: str, out: StateDict):
    """A ``GatedMLP``, or a ``MoE``: its gate, its stacked experts as they
    are (E, D, I) / (E, I, D), its shared expert."""
    if "gate_linear" in p:
        _linear(p["gate_linear"], f"{prefix}.gate_linear", out)
        for w in ("gate_bias", "expert_w1", "expert_w2", "expert_w3"):
            out[f"{prefix}.{w}"] = _a(p[w])
        p, prefix = p["shared_expert"], f"{prefix}.shared_expert"
    for w in ("w1", "w2", "w3"):
        _linear(p[w], f"{prefix}.{w}", out)


def moe_state_dict(variables) -> StateDict:
    """``MoE`` variables -> the port's ``MoE``."""
    return _unprefixed(_mlp, variables["params"])


def _hybrid_transformer(p, prefix: str, out: StateDict):
    for name, layer in p.items():
        lp = f"{prefix}.layers.{name.split('_')[1]}"
        attn = layer["self_attn"]
        _lstm(attn["rnn"], f"{lp}.self_attn.rnn", out)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(attn[proj], f"{lp}.self_attn.{proj}", out)
        _mlp(layer["mlp"], f"{lp}.mlp", out)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{lp}.{norm}.weight"] = _a(layer[norm]["weight"])


def _unprefixed(fill, *args) -> StateDict:
    """The state dict ``fill(*args, prefix, out)`` writes under a dummy
    prefix, with the prefix taken off."""
    out: StateDict = {}
    fill(*args, "_", out)
    return {k[2:]: v for k, v in out.items()}


def transformer_state_dict(variables) -> StateDict:
    """An HCodec hybrid ``Transformer``'s variables (the MoE's too) -> the
    port's ``Transformer``."""
    return _unprefixed(_hybrid_transformer, variables["params"])


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


def _seanet_encoder(enc, n: int, out: StateDict, unfold: bool):
    """A SEANet encoder of ``n`` ratios at ``encoder.model.{i}``."""
    _sconv(enc["conv_in"], "encoder.model.0", out, unfold)
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


def _hcodec10(variables, cfg, unfold: bool) -> StateDict:
    p, out = variables["params"], {}
    _seanet_encoder(p["encoder"], len(cfg.seanet_ratios), out, unfold)
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


def _mimi_transformer(p, prefix: str, out: StateDict):
    """A ``MimiTransformer``'s params (layers stacked on a leading axis) ->
    ``{prefix}.layers.{i}`` (the fused ``in_proj_weight`` as it is)."""
    stacked = p["layers"]["layer"]
    for i in range(_a(stacked["layer_scale_1"]).shape[0]):
        lp, pre = _index(stacked, i), f"{prefix}.layers.{i}"
        _layernorm(lp["norm1"], f"{pre}.norm1", out)
        _layernorm(lp["norm2"], f"{pre}.norm2", out)
        out[f"{pre}.self_attn.in_proj_weight"] = lp["in_proj"]["kernel"].T
        _linear(lp["out_proj"], f"{pre}.self_attn.out_proj", out)
        _linear(lp["linear1"], f"{pre}.linear1", out)
        _linear(lp["linear2"], f"{pre}.linear2", out)
        for ls in ("layer_scale_1", "layer_scale_2"):
            out[f"{pre}.{ls}.scale"] = _a(lp[ls])


def _aggregators(p, names, out: StateDict):
    for name in names:
        if name in p:
            out[f"{name}.query_embedding"] = _a(
                p[name]["query_embedding"]).reshape(1, -1, 1)
            _mimi_transformer(p[name]["transformer"],
                              f"{name}.transformer.transformer", out)


def _projected(p, prefix: str, out: StateDict):
    """A ``MimiProjectedTransformer`` (projections only where the widths
    differ)."""
    for proj in ("input_proj", "output_proj"):
        if proj in p:
            _linear(p[proj], f"{prefix}.{proj}", out)
    _mimi_transformer(p["transformer"], f"{prefix}.transformer", out)


def hcodec15_train_state_dict(variables, cfg) -> StateDict:
    """HCodec-1.5 (``AdaptiveHCodec``) variables ({"params", "codebook"};
    ``cfg`` an ``AdaptiveConfig``) -> the state dict of the port's
    ``AdaptiveHCodec(trainable=True)``: the SEANet encoder's weight norm as
    ``weight_g``/``weight_v``, the four codebook buffers, the semantic
    encoder and decoder, both aggregators, the bottleneck and the
    decoder."""
    base, p, out = cfg.base, variables["params"], {}
    _seanet_encoder(p["encoder"], len(base.seanet_ratios), out, True)
    _codec_streams(variables, base, out)
    _codec_decoder10(p["decoder"], "decoder", out)
    _aggregators(p, ("acoustic_aggregator", "semantic_aggregator"), out)
    _projected(p["bottleneck"], "bottleneck_transformer", out)
    return out


def _cnx_adapter(p, prefix: str, proj_first: bool, out: StateDict):
    """FlexiCodec's ``SemanticEncoderCNX`` (the 1x1 conv at index 0) or
    ``SemanticDecoderCNX`` (the conv after the blocks), weight norm kept."""
    stacked = p["blocks"]["stack"]["block"]
    n = _a(stacked["norm"]["scale"]).shape[0]
    _conv(p["proj"], f"{prefix}.{0 if proj_first else n}", out, True)
    for i in range(n):
        block, bp = _index(stacked, i), f"{prefix}.{i + int(proj_first)}"
        _conv(block["dwconv"], f"{bp}.dwconv", out)
        _layernorm(block["norm"], f"{bp}.norm", out)
        _linear(block["pwconv1"], f"{bp}.pwconv1", out)
        _linear(block["pwconv2"], f"{bp}.pwconv2", out)


def flexicodec_train_state_dict(variables, cfg) -> StateDict:
    """FlexiCodec variables ({"params"}; ``cfg`` a ``FlexiCodecConfig``)
    -> the state dict of the port's ``FlexiCodec(trainable=True)``: every
    weight-normed conv (the DAC encoder, the RVQ projections, the DAC
    decoder and its transposed convs, the adapters' 1x1 convs) as
    ``weight_g``/``weight_v``; the FSQ projections, the aggregators and
    the bottleneck where the config has them."""
    p, out = variables["params"], {}
    enc, n = p["encoder"], len(cfg.encoder_rates)
    _conv(enc["conv_pre"], "dac.encoder.block.0", out, True)
    for i in range(n):
        bp, blk = f"dac.encoder.block.{i + 1}.block", enc[f"block_{i}"]
        for j in range(3):
            _dac_residual_unit(blk[f"res_{j}"], f"{bp}.{j}", out, True)
        _snake(blk["snake"], f"{bp}.3.alpha", out)
        _conv(blk["down"], f"{bp}.4", out, True)
    _snake(enc["snake_post"], f"dac.encoder.block.{n + 1}.alpha", out)
    _conv(enc["conv_post"], f"dac.encoder.block.{n + 2}", out, True)
    for i in range(cfg.n_codebooks):
        q, qp = p["quantizer"][f"quantizers_{i}"], f"dac.quantizer.quantizers.{i}"
        _conv(q["in_proj"], f"{qp}.in_proj", out, True)
        _conv(q["out_proj"], f"{qp}.out_proj", out, True)
        out[f"{qp}.codebook.weight"] = _a(q["codebook"])
    _wave_generator(p["decoder"], "dac.decoder", len(cfg.decoder_rates), out,
                    True)
    _cnx_adapter(p["convnext_encoder"], "convnext_encoder", True, out)
    _cnx_adapter(p["convnext_decoder"], "convnext_decoder", False, out)
    for proj in ("project_in", "project_out"):
        if proj in p.get("semantic_vq", {}):
            _linear(p["semantic_vq"][proj], f"semantic_vq.fsq.{proj}", out)
    _aggregators(p, ("semantic_aggregator", "acoustic_aggregator"), out)
    if "bottleneck_transformer" in p:
        _projected(p["bottleneck_transformer"], "bottleneck_transformer",
                   out)
    return out


_WN_NAMES = ((".weight_g", ".weight_v"),
             (".parametrizations.weight.original0",
              ".parametrizations.weight.original1"))


def fold_weight_norm(sd: StateDict) -> StateDict:
    """Each weight-normed conv of a state dict (``weight_g``/``weight_v``,
    or torch's ``parametrizations.weight.original0/1``) folded into
    ``weight`` = g v / sqrt(sum v^2 + 1e-12), the sum over every axis where
    g has length 1 (in and K for a conv, out and K for a transposed conv),
    numpy fp32; every other entry as it is."""
    out = {}
    for k, v in sd.items():
        for g_name, v_name in _WN_NAMES:
            if k.endswith(v_name):
                break
            if k.endswith(g_name):
                stem = k[:-len(g_name)]
                g = np.asarray(v, np.float32)
                w = np.asarray(sd[stem + v_name], np.float32)
                axes = tuple(i for i in range(w.ndim) if g.shape[i] == 1)
                norm = np.sqrt((w ** 2).sum(axis=axes, keepdims=True)
                               + np.float32(1e-12))
                out[stem + ".weight"] = w * (g / norm)
                break
        else:
            out[k] = v
    return out


_EMA_KEYS = (".embed_avg", ".cluster_size", ".initted", ".inited")


def hcodec_inference_keys(sd: StateDict) -> StateDict:
    """The keys the port's inference ``HCodec`` loads: the semantic decoder
    (the training target) and the codebooks' EMA statistics dropped, and
    weight norm folded (:func:`fold_weight_norm`)."""
    return {k: v for k, v in fold_weight_norm(sd).items()
            if not k.startswith("semantic_decoder.")
            and not k.endswith(_EMA_KEYS)}


def hcodec15_inference_keys(sd: StateDict) -> StateDict:
    """A state dict in the reference HCodec-1.5 layout (what
    ``export_hcodec15_state_dict`` writes, or the released checkpoint) ->
    the keys of the port's ``AdaptiveHCodec``: weight norm folded, the
    codebooks' EMA statistics dropped (the semantic decoder stays, for the
    eval forward)."""
    return {k: v for k, v in fold_weight_norm(sd).items()
            if not k.endswith(_EMA_KEYS)}


def flexicodec_inference_keys(sd: StateDict) -> StateDict:
    """A FlexiCodec state dict in the reference layout (what
    ``export_flexicodec_state_dict`` writes, or the released safetensors)
    -> the port's ``FlexiCodec`` keys: the DAC and adapter convs' weight
    norm folded."""
    return fold_weight_norm(sd)


def sensevoice_keys(sd: StateDict, cfg) -> StateDict:
    """A funasr SenseVoiceSmall state dict -> the port's
    ``SenseVoiceSemanticEncoder``: the ``encoder.*`` entries and the first
    ``cfg.embed_vocab`` rows of ``embed.weight`` (the keys the JAX package's
    ``convert_sensevoice`` reads); the ASR head and the rest are left
    out."""
    out = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    out["embed.weight"] = sd["embed.weight"][:cfg.embed_vocab]
    return out


# ---------------------------------------------------------------------------
# The modules no shipped model builds: the conformer, the streaming
# transformer, GRVQ, the SEANet decoder family
# ---------------------------------------------------------------------------

def conformer_state_dict(variables) -> StateDict:
    """``ConformerEncoder`` variables -> the port's ``ConformerEncoder``
    (``layers_{i}`` -> ``layers.{i}``)."""
    out: StateDict = {}
    for name, lp in variables["params"].items():
        pre = f"layers.{name.split('_')[1]}"
        for ff in ("ff1", "ff2"):
            _layernorm(lp[ff]["norm"], f"{pre}.{ff}.norm", out)
            _linear(lp[ff]["ff1"], f"{pre}.{ff}.ff1", out)
            _linear(lp[ff]["ff2"], f"{pre}.{ff}.ff2", out)
        attn = lp["attn"]
        _layernorm(attn["norm"], f"{pre}.attn.norm", out)
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            _linear(attn[proj], f"{pre}.attn.{proj}", out)
        conv = lp["conv"]
        for norm in ("norm", "dwnorm"):
            _layernorm(conv[norm], f"{pre}.conv.{norm}", out)
        _linear(conv["pw1"], f"{pre}.conv.pw1", out)
        _linear(conv["pw2"], f"{pre}.conv.pw2", out)
        _hconv(conv["dwconv"], f"{pre}.conv.dwconv", out)
        _layernorm(lp["post_norm"], f"{pre}.post_norm", out)
    return out


def joint_attention_state_dict(variables) -> StateDict:
    """``JointAttention`` variables -> the port's (bias-free linears)."""
    out: StateDict = {}
    for name, p in variables["params"].items():
        _linear(p, name, out)
    return out


def _streaming_core(p, prefix: str, out: StateDict):
    """A ``StreamingTransformer``'s scanned layers (stacked on a leading
    axis) -> ``{prefix}layers.{i}``."""
    stacked = p["layers"]
    for i in range(_a(stacked["norm1"]["weight"]).shape[0]):
        lp, pre = _index(stacked, i), f"{prefix}layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(lp["self_attn"][proj], f"{pre}.self_attn.{proj}", out)
        for norm in ("norm1", "norm2"):
            out[f"{pre}.{norm}.weight"] = lp[norm]["weight"]
        for w in ("w1", "w2", "w3"):
            _linear(lp["gating"][w], f"{pre}.gating.{w}", out)


def streaming_state_dict(variables) -> StateDict:
    """``StreamingTransformer`` or ``ProjectedStreamingTransformer``
    variables -> the port's module of the same name."""
    p, out = variables["params"], {}
    if "core" in p:
        _linear(p["proj_in"], "proj_in", out)
        _linear(p["proj_out"], "proj_out", out)
        _streaming_core(p["core"], "core.", out)
    else:
        _streaming_core(p, "", out)
    return out


def _grvq_layer(p, prefix: str, out: StateDict):
    for proj in ("in_proj_a", "in_proj_b", "out_proj_a", "out_proj_b"):
        _conv(p[proj], f"{prefix}{proj}", out)  # weight norm folded
    for cb in ("codebook_a", "codebook_b"):
        out[f"{prefix}{cb}"] = _a(p[cb])


def grvq_state_dict(variables) -> StateDict:
    """``AutoGroupVectorQuantize`` or ``AutoGroupResidualVectorQuantize``
    variables -> the port's module of the same name."""
    p, out = variables["params"], {}
    if "codebook_a" in p:
        _grvq_layer(p, "", out)
    for name, q in p.items():
        if name.startswith("quantizers_"):
            _grvq_layer(q, f"quantizers.{name.split('_')[1]}.", out)
    return out


def seanet_decoder_state_dict(variables, n_residual_layers: int = 1,
                              unfold: bool = False) -> StateDict:
    """``SEANetDecoder`` variables -> the port's ``SEANetDecoder`` at the
    reference's ``model.{i}`` (weight norm folded, or with ``unfold``
    kept for ``weight_norm=True``)."""
    p, out = variables["params"], {}
    _sconv(p["conv_in"], "model.0", out, unfold)
    i = 1
    if "lstm" in p:
        _lstm(p["lstm"]["lstm"], "model.1.lstm", out)
        i = 2
    r = 0
    while f"up_{r}" in p:
        _conv_transpose_wrapped(p[f"up_{r}"], f"model.{i + 1}", out, unfold)
        for j in range(n_residual_layers):
            res, pre = p[f"res_{r}_{j}"], f"model.{i + 2 + j}"
            for ours, theirs in (("block_0", "block.1"), ("block_1", "block.3"),
                                 ("shortcut", "shortcut")):
                if ours in res:
                    _sconv(res[ours], f"{pre}.{theirs}", out, unfold)
        i, r = i + 2 + n_residual_layers, r + 1
    _sconv(p["conv_out"], f"model.{i + 1}", out, unfold)
    return out


def _conv_transpose_wrapped(p, prefix: str, out: StateDict, unfold: bool):
    _convtr(p, f"{prefix}.convtr.convtr", out, unfold)


def attn_block_state_dict(variables) -> StateDict:
    """``AttnBlock`` variables -> the port's ``AttnBlock``."""
    p, out = variables["params"], {}
    _layernorm(p["norm"], "norm", out)
    for name in ("q", "k", "v", "proj_out"):
        _hconv(p[name], name, out)
    return out


def _resblock1(p, prefix: str, out: StateDict):
    i = 0
    while f"conv1_{i}" in p:
        _conv(p[f"conv1_{i}"], f"{prefix}conv1.{i}", out)
        _conv(p[f"conv2_{i}"], f"{prefix}conv2.{i}", out)
        if f"gamma_{i}" in p:
            out[f"{prefix}gamma.{i}"] = _a(p[f"gamma_{i}"])
        i += 1


def resblock1_state_dict(variables) -> StateDict:
    """``ResBlock1`` variables -> the port's (weight norm folded)."""
    out: StateDict = {}
    _resblock1(variables["params"], "", out)
    return out


def vocos_resnet_state_dict(variables) -> StateDict:
    """``VocosResNetBackbone`` variables -> the port's (weight norm
    folded)."""
    p, out = variables["params"], {}
    _conv(p["embed"], "embed", out)
    i = 0
    while f"resnet_{i}" in p:
        _resblock1(p[f"resnet_{i}"], f"resnet.{i}.", out)
        i += 1
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
