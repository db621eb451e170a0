"""Weight bridge: the JAX package's variables -> the port's state dicts.

Takes the nested dicts of numpy arrays that ``jax.device_get`` returns for
the JAX package's modules and produces state dicts the port's modules load
with ``load_state_dict`` (numpy values; wrap them with ``torch.as_tensor``).
numpy only: this module imports neither ``jax`` nor ``torch``.

* :func:`llmsft_state_dict`: ``LLMSFT`` variables -> the reference torch
  layout (split q/k/v and gate/up, Linear weights (out, in)), key for key
  what ``utils/convert.py export_custom_llama_state_dict`` writes.
* :func:`wavlm_state_dict`: ``Wav2Vec2Model`` (WavLM) variables -> the HF
  layout, which ``utils/convert.py convert_hf_wav2vec2`` maps back.
* :func:`bicodec_decoder_state_dict`: the detokenize subset of
  ``BiCodec`` variables -> the reference layout, key for key what
  ``utils/convert_bicodec.py export_bicodec_state_dict`` writes for those
  modules (weight norm folded).

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


def _conv(p, prefix: str, out: StateDict):
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

def llmsft_state_dict(variables, cfg) -> StateDict:
    """LLMSFT (or CodecLM) variables -> reference-layout state dict."""
    p = variables["params"]
    lm = p["lm"]
    d = cfg.hidden_size
    sd: StateDict = {
        "codec_embedding.weight": _a(lm["codec_embedding"]["embedding"]),
        "output_head.weight": _a(lm["output_head"]["kernel"]).T,
        "norm.weight": _a(lm["backbone"]["norm"]["weight"]),
    }
    layers = lm["backbone"]["layers"]
    for i in range(cfg.num_layers):
        pre = f"layers.{i}"
        qkv = _a(layers["self_attn"]["qkv_proj"]["kernel"])[i]
        sd[f"{pre}.self_attn.q_proj.weight"] = qkv[:, :d].T
        sd[f"{pre}.self_attn.k_proj.weight"] = qkv[:, d:2 * d].T
        sd[f"{pre}.self_attn.v_proj.weight"] = qkv[:, 2 * d:].T
        sd[f"{pre}.self_attn.o_proj.weight"] = _a(
            layers["self_attn"]["o_proj"]["kernel"])[i].T
        gate_up = _a(layers["mlp"]["gate_up_proj"]["kernel"])[i]
        inter = gate_up.shape[1] // 2
        sd[f"{pre}.mlp.gate_proj.weight"] = gate_up[:, :inter].T
        sd[f"{pre}.mlp.up_proj.weight"] = gate_up[:, inter:].T
        sd[f"{pre}.mlp.down_proj.weight"] = _a(
            layers["mlp"]["down_proj"]["kernel"])[i].T
        sd[f"{pre}.input_layernorm.weight"] = _a(
            layers["input_layernorm"]["weight"])[i]
        sd[f"{pre}.post_attention_layernorm.weight"] = _a(
            layers["post_attention_layernorm"]["weight"])[i]
    if "task_embedding" in p:
        sd["task_embedding.weight"] = _a(p["task_embedding"]["embedding"])
        sd["enroll_sos_embedding.weight"] = _a(p["enroll_sos_embedding"])
        sd["mix_sos_embedding.weight"] = _a(p["mix_sos_embedding"])
        _linear(p["adapter"], "adapter", sd)
    elif "mix_sos_embedding" in p:
        sd["mix_sos_embedding.weight"] = _a(p["mix_sos_embedding"])
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
