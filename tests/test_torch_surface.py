"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported).

For every ``.py`` file of ``unified_audio_tpu/`` that has a counterpart at
the same path in ``unified_audio_tpu_torch/``, each public module-level
function and class, and each public method of a class of the same name,
must be defined in the port's file (a method also by a base class of that
file, a property also as an attribute the class sets on ``self``), or be
in ``RENAMED`` (whose port target must exist), or in ``JAX_ONLY`` with its
reason. The JAX files without a counterpart must be exactly
``NOT_PORTED``, the set ROADMAP.md gives.
"""
import ast
import functools
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "unified_audio_tpu"
PORT_PKG = REPO / "unified_audio_tpu_torch"

NOT_PORTED = {
    "ops/pallas/__init__.py", "ops/pallas/paged_attention.py",
    "ops/pallas/vq_kernel.py", "utils/param_pack.py",
    "utils/convert_bicodec.py", "utils/convert_hcodec.py",
}

# JAX "file:Name" or "file:Class.method" -> port "file:Name" or
# "file:Class.method" that does the same job under another name
RENAMED = {
    "data/data_module.py:DevicePrefetcher": "data/data_module.py:Prefetcher",
    "eval/utmos.py:convert_utmos": "eval/utmos.py:utmos_head_keys",
    "models/bicodec/speaker.py:GEGLUFeedForward":
        "models/bicodec/speaker.py:geglu_feed_forward",
    "models/hcodec/flexicodec.py:FlexiFSQ.indices_to_codes":
        "models/hcodec/flexicodec.py:FlexiFSQ.from_indices",
    "models/lm/llama.py:LlamaBackbone.prefill":
        "models/lm/llama.py:LlamaBackbone.cached_forward",
    "models/lm/llama.py:LlamaBackbone.decode_step":
        "models/lm/llama.py:LlamaBackbone.cached_forward",
    "train/optim.py:make_optimizer": "train/optim.py:Optimizer",
    "utils/precision.py:bf16_params": "utils/precision.py:cast_floating",
    "utils/precision.py:f32_params": "utils/precision.py:cast_floating",
    "utils/profiling.py:annotate": "utils/profiling.py:Recorder.span",
}

FROM_RANDOM = ("builds the JAX module and initializes its variables; the "
               "port constructs the torch module and fills it with "
               "utils/initialization.py init_random_")
TORCH_LAYOUT = ("reads a torch-layout checkpoint into JAX variables; the "
                "port's modules take that layout with load_state_dict")
TRACED_ARGS = ("passes frozen weights into an outer jit as traced "
               "arguments; a torch module holds its weights, so the port "
               "calls the module itself")

# JAX "file:Name" or "file:Class.method" -> why the port has no counterpart
JAX_ONLY = {
    "eval/utmos.py:BLSTM": "the JAX scan of a bidirectional LSTM; the "
                           "port's UTMOSHead runs nn.LSTM(bidirectional="
                           "True)",
    "eval/utmos.py:UTMOSPredictor.from_random": FROM_RANDOM,
    "eval/utmos.py:export_utmos_state_dict":
        "JAX variables -> the torch layout; the port's UTMOSHead."
        "state_dict() is that layout",
    "models/bicodec/tokenizer.py:BiCodecTokenizer.from_random": FROM_RANDOM,
    "models/bicodec/tokenizer.py:BiCodecTokenizer.tokenize_with_vars":
        TRACED_ARGS,
    "models/hcodec/adaptive_tokenizer.py:AdaptiveHCodecTokenizer."
    "from_random": FROM_RANDOM,
    "models/hcodec/tokenizer.py:HCodecTokenizer.from_random": FROM_RANDOM,
    "models/unise/model.py:UniSE.frozen_variables": TRACED_ARGS,
    "models/unise/model.py:UniSE.wavlm_feats_pure": TRACED_ARGS,
    "nn/recurrent.py:lstm_scan": "the JAX LSTM's lax.scan over time; the "
                                 "port's LSTM runs torch's (cuDNN on the "
                                 "card)",
    "parallel/mesh.py:param_shardings": "a GSPMD sharding spec; the port "
                                        "cuts tensors itself over "
                                        "torch.distributed (shard_lm_)",
    "parallel/mesh.py:replicated": "a GSPMD sharding spec; a tensor the "
                                   "port does not cut is whole on every "
                                   "rank",
    "parallel/mesh.py:batch_sharding": "a GSPMD sharding spec; the port "
                                       "cuts batches with shard_batch",
    "train/checkpoint.py:CheckpointManager.wait":
        "orbax saves asynchronously; the port's save is synchronous",
    "utils/convert.py:convert_hf_wav2vec2": TORCH_LAYOUT,
    "utils/convert.py:convert_hf_llama_layers": TORCH_LAYOUT,
    "utils/convert.py:convert_custom_llama": TORCH_LAYOUT,
    "utils/convert.py:convert_sensevoice": TORCH_LAYOUT,
    "utils/convert.py:export_custom_llama_state_dict":
        "JAX variables -> the torch layout; the port's CodecLM.state_dict() "
        "is that layout",
    "utils/initialization.py:init_on_cpu":
        "runs a JAX init under jit on the host CPU device and moves the "
        "tree once; a torch module is built on the CPU and moved with .to",
}

# a method of every Flax module that has no torch counterpart by name
JAX_ONLY_METHODS = {
    "setup": "Flax builds a module's submodules in setup; a torch module "
             "builds them in __init__",
}


def _defined_on_self(cls: ast.ClassDef):
    """Attribute names the class's methods set on ``self``."""
    names = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    names.add(t.attr)
    return names


def surface(path: Path, with_attrs: bool = False):
    """{public function: None, public class: {its names}}; a class's names
    are its public methods (``with_attrs``: every method, attribute and
    class-level name, its same-file bases' included)."""
    tree = ast.parse(path.read_text())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def members(cls, seen=()):
        out = set()
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(node.name)
            elif with_attrs and isinstance(node, ast.Assign):
                out.update(t.id for t in node.targets
                           if isinstance(t, ast.Name))
            elif with_attrs and isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                out.add(node.target.id)
        if with_attrs:
            out |= _defined_on_self(cls)
            for base in cls.bases:
                if (isinstance(base, ast.Name) and base.id in classes
                        and base.id not in seen):
                    out |= members(classes[base.id], seen + (cls.name,))
        return out if with_attrs else {m for m in out
                                       if not m.startswith("_")}

    found = {}
    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            found[node.name] = None
        elif isinstance(node, ast.ClassDef):
            found[node.name] = members(node)
    return found


def _files(pkg):
    return {str(p.relative_to(pkg)) for p in pkg.rglob("*.py")}


def _port_has(target):
    rel, name = target.split(":")
    path = PORT_PKG / rel
    if not path.exists():
        return False
    found = surface(path, with_attrs=True)
    cls, _, meth = name.partition(".")
    if cls not in found:
        return False
    return not meth or meth in (found[cls] or ())


@functools.lru_cache(maxsize=None)
def missing():
    """JAX public names without a counterpart in the port, as
    "file:Name" / "file:Class.method"."""
    out = []
    for rel in sorted(_files(JAX_PKG) & _files(PORT_PKG)):
        jax_side = surface(JAX_PKG / rel)
        port_side = surface(PORT_PKG / rel, with_attrs=True)
        for name, methods in jax_side.items():
            if name not in port_side:
                out.append(f"{rel}:{name}")
                continue
            for m in sorted(methods or ()):
                if m not in (port_side[name] or ()):
                    out.append(f"{rel}:{name}.{m}")
    return tuple(out)


def test_not_ported_files_are_roadmaps():
    assert _files(JAX_PKG) - _files(PORT_PKG) == NOT_PORTED
    text = (REPO / "ROADMAP.md").read_text()
    for stem in ("ops/pallas", "paged_attention", "vq_kernel",
                 "param_pack", "convert_bicodec", "convert_hcodec"):
        assert stem in text, f"ROADMAP.md's Not ported omits {stem}"


def test_every_public_callable_has_a_counterpart():
    unexplained = [key for key in missing()
                   if key not in RENAMED and key not in JAX_ONLY
                   and key.rpartition(".")[2] not in JAX_ONLY_METHODS]
    assert unexplained == []


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_target_exists(key):
    assert key in missing(), f"{key} is ported under its own name now"
    assert _port_has(RENAMED[key]), f"{RENAMED[key]} is not in the port"


def test_jax_only_entries_are_current_and_reasoned():
    gaps = set(missing())
    for key, reason in JAX_ONLY.items():
        assert key in gaps, f"{key} is ported now: drop it from JAX_ONLY"
        assert len(reason.split()) >= 6, key
    assert any(k.endswith(".setup") for k in gaps)


@pytest.mark.parametrize("key", [
    "models/lm/llama.py:LlamaBackbone.decode_step_multi",
    "models/lm/llama.py:CodecLM.decode_ids_multi",
    "ops/dsp.py:cosine_window", "ops/dsp.py:mdct", "ops/dsp.py:imdct",
    "ops/dsp.py:stft_logmel", "models/unise/model.py:UniSE.stft_logmel",
    "models/bicodec/speaker.py:tap_pool",
    "models/bicodec/speaker.py:tsdp_pool",
    "models/bicodec/speaker.py:tstp_pool",
    "ops/quant.py:FactorizedVectorQuantize.decode_latents",
    "nn/conv.py:unpad1d", "utils/config.py:load_config",
    "utils/config.py:to_dict",
    "serve/engine.py:ContinuousBatchingEngine.admit"])
def test_ported_callable(key):
    """The callables that a file-list diff could not see are ported under
    their JAX names."""
    assert key not in RENAMED and key not in JAX_ONLY
    assert _port_has(key)
