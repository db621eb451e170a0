"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py),
and the check that the port imports no JAX.

The port (``unified_audio_tpu_torch``) is held against the JAX package on
the CPU: the same numpy-seeded inputs go through the JAX function and its
port, with weights carried over by ``unified_audio_tpu_torch.utils.convert``.
Tolerances, unless a test states otherwise: floats within atol/rtol 1e-4
(the two frameworks reduce in different orders), token ids exact under
greedy decoding.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

# tier-1 runs several pytest workers on one machine: keep torch narrow
torch.set_num_threads(2)

from unified_audio_tpu.models.lm.llama import LlamaConfig  # noqa: E402
from unified_audio_tpu.models.lm.sft import LLMSFT  # noqa: E402
from unified_audio_tpu_torch.models.lm import llama as t_llama  # noqa: E402
from unified_audio_tpu_torch.models.lm.sft import LLMSFT as TLLMSFT  # noqa: E402
from unified_audio_tpu_torch.utils import convert as t_convert  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)


def to_torch(sd):
    return {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}


def random_variables(module, *args, seed=0, method=None, out_gain=None):
    """Seeded numpy variables in the tree of ``module.init`` (traced with
    ``jax.eval_shape``, never compiled): fan-in scaled normal kernels, gains
    and scales near 1, small biases, unit-normal tables. ``out_gain`` sets
    the weight-norm gain of the final vocoder conv (``conv_post``), so the
    waveform's pre-tanh range is O(1) as in a trained codec rather than
    saturated, where fp32 rounding differences would be amplified."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, method=method))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "gamma", "alpha", "kernel_g", "weight",
                    "gru_rel_pos_const"):
            x = 1.0 + 0.1 * rng.standard_normal(s.shape)
            if out_gain is not None and "conv_post" in jax.tree_util.keystr(
                    path):
                x = out_gain * x
        elif name == "bias":
            x = 0.1 * rng.standard_normal(s.shape)
        elif name in ("embedding", "codebook", "rel_attn_embed",
                      "enroll_sos_embedding", "mix_sos_embedding"):
            x = rng.standard_normal(s.shape)
        else:
            x = rng.standard_normal(s.shape) / np.sqrt(
                max(int(np.prod(s.shape[:-1])), 1))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tiny_bicodec_config():
    from unified_audio_tpu.models.bicodec.bicodec import BiCodecConfig

    return BiCodecConfig(
        ref_segment_duration=0.2,
        feat_dim=32, vocos_dim=32, vocos_intermediate_dim=64,
        vocos_num_layers=1, latent_dim=32, codebook_size=64, codebook_dim=8,
        spk_out_dim=32, spk_latent_dim=16, token_num=4, fsq_levels=(4, 4, 4),
        num_mels=32, mel_n_fft=256, mel_win=160, mel_hop=80,
        wave_channels=32, wave_rates=(8, 5, 4, 2), wave_kernels=(16, 11, 8, 4),
    )


def tiny_wavlm_config():
    from unified_audio_tpu.models.ssl import wav2vec2 as ssl_mod

    return ssl_mod.SSLConfig(
        hidden_size=24, num_layers=2, num_heads=4, intermediate_size=32,
        conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, use_rel_pos_bias=True,
        num_buckets=32, max_distance=80,
    )


def bicodec_decoder_variables(cfg, seed=1):
    """Random variables of BiCodec's detokenize path (what the port
    builds)."""
    from unified_audio_tpu.models.bicodec.bicodec import BiCodec

    sem = np.zeros((1, 4), np.int32)
    glob = np.zeros((1, cfg.token_num, 1), np.int32)
    return random_variables(BiCodec(cfg), sem, glob, seed=seed,
                            method="detokenize", out_gain=0.05)


def wavlm_variables(cfg, seed=2):
    from unified_audio_tpu.models.ssl import wav2vec2 as ssl_mod

    return random_variables(ssl_mod.Wav2Vec2Model(cfg),
                            np.zeros((1, 3200), np.float32), seed=seed)


def port_config(cfg):
    """A JAX package config dataclass -> the port's dataclass of the same
    name and fields."""
    return t_llama.LlamaConfig(**dataclasses.asdict(cfg))


def tiny_lm_config():
    return LlamaConfig(global_size=16, semantic_size=32, hidden_size=32,
                       num_layers=2, num_heads=4)


def jax_sft(cfg, feats_dim=12, seed=0):
    """A JAX LLMSFT and seeded random variables for it."""
    sft = LLMSFT(cfg, num_tasks=3, feats_dim=feats_dim)
    variables = random_variables(
        sft, 0, None, np.zeros((1, 10, feats_dim), np.float32),
        np.zeros((1, 4), np.int32), np.zeros((1, 10), np.int32), seed=seed)
    return sft, variables


def port_sft(cfg, variables, feats_dim=12):
    """The port's fp32 LLMSFT loaded with the JAX LLMSFT's weights."""
    m = TLLMSFT(port_config(cfg), num_tasks=3, feats_dim=feats_dim)
    m.load_state_dict(to_torch(t_convert.llmsft_state_dict(variables, cfg)))
    return m.eval()


def tiny_unise_jax():
    """The tiny UniSE stack of tests/test_cli.py (WavLM with the relative
    position bias, a 0.4-s segment), with seeded random weights."""
    from unified_audio_tpu.models.bicodec.tokenizer import BiCodecTokenizer
    from unified_audio_tpu.models.ssl import wav2vec2 as ssl_mod
    from unified_audio_tpu.models.unise.model import UniSE, UniSEConfig

    bicodec_cfg = tiny_bicodec_config()
    wavlm_cfg = tiny_wavlm_config()
    cfg = UniSEConfig(
        segment_seconds=0.4, feats_dim=24, global_tokens=4,
        llm=LlamaConfig(global_size=64, semantic_size=64, hidden_size=32,
                        num_layers=2, num_heads=4),
    )
    # the XLSR frontend serves tokenize only: neither side builds it here
    tok = BiCodecTokenizer(bicodec_cfg, bicodec_decoder_variables(bicodec_cfg),
                           ssl_mod.SSLConfig(), None)
    _, sft_vars = jax_sft(cfg.llm, cfg.feats_dim, seed=3)
    return UniSE(cfg, tok, wavlm_cfg, wavlm_variables(wavlm_cfg),
                 sft_params=sft_vars)


def port_wavlm(cfg, variables):
    from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl

    m = t_ssl.Wav2Vec2Model(t_ssl.SSLConfig(**dataclasses.asdict(cfg)))
    m.load_state_dict(to_torch(t_convert.wavlm_state_dict(
        jax.device_get(variables), cfg)))
    return m.eval()


def port_bicodec(cfg, variables):
    from unified_audio_tpu_torch.models.bicodec import bicodec as t_bicodec

    m = t_bicodec.BiCodec(t_bicodec.BiCodecConfig(**dataclasses.asdict(cfg)))
    m.load_state_dict(to_torch(t_convert.bicodec_decoder_state_dict(
        jax.device_get(variables), cfg)))
    return m.eval()


def tiny_xlsr_config():
    """XLSR-53's shape (a LayerNorm after every conv, conv biases, pre-LN
    layers, the final encoder LayerNorm) at width 16, with 17 layers so
    that layers 11, 14 and 16 are distinct."""
    from unified_audio_tpu.models.ssl import wav2vec2 as ssl_mod

    return ssl_mod.SSLConfig(
        hidden_size=16, num_layers=17, num_heads=2, intermediate_size=32,
        conv_dim=(16,) * 7, conv_bias=True, feat_extract_norm="layer",
        do_stable_layer_norm=True, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4)


def tiny_tokenizer_config():
    """The tiny BiCodec over the 16-wide XLSR features."""
    return dataclasses.replace(tiny_bicodec_config(), feat_dim=16)


def bicodec_variables(cfg, seed=4):
    """Random variables of the whole BiCodec (tokenize and detokenize),
    BatchNorm statistics included: means small, variances in [0.5, 1.5]."""
    from unified_audio_tpu.models.bicodec.bicodec import BiCodec

    feat = np.zeros((1, 10, cfg.feat_dim), np.float32)
    wav = np.zeros((1, cfg.latent_hop_length * 10), np.float32)
    variables = random_variables(BiCodec(cfg), feat, wav, seed=seed,
                                 out_gain=0.05)
    rng = np.random.default_rng(seed + 100)

    def stat(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        stat, variables["batch_stats"])
    return variables


def xlsr_variables(cfg, seed=5):
    from unified_audio_tpu.models.ssl import wav2vec2 as ssl_mod

    return random_variables(ssl_mod.Wav2Vec2Model(cfg),
                            np.zeros((1, 3200), np.float32), seed=seed)


def jax_tokenizer():
    """A JAX BiCodecTokenizer of the tiny configs, with seeded weights."""
    from unified_audio_tpu.models.bicodec.tokenizer import BiCodecTokenizer

    cfg, ssl_cfg = tiny_tokenizer_config(), tiny_xlsr_config()
    return BiCodecTokenizer(cfg, bicodec_variables(cfg), ssl_cfg,
                            xlsr_variables(ssl_cfg))


def port_tokenizer(tok):
    """The port's tokenizing BiCodecTokenizer with ``tok``'s weights."""
    from unified_audio_tpu_torch.models.bicodec import bicodec as t_bicodec
    from unified_audio_tpu_torch.models.bicodec.tokenizer import (
        BiCodecTokenizer)
    from unified_audio_tpu_torch.models.ssl import wav2vec2 as t_ssl

    m = t_bicodec.BiCodec(
        t_bicodec.BiCodecConfig(**dataclasses.asdict(tok.config)),
        tokenize=True)
    m.load_state_dict(to_torch(t_convert.bicodec_state_dict(
        jax.device_get(tok.variables), tok.config)))
    ssl_cfg = tok.ssl.config
    ssl = t_ssl.Wav2Vec2Model(t_ssl.SSLConfig(**dataclasses.asdict(ssl_cfg)))
    ssl.load_state_dict(to_torch(t_convert.xlsr_state_dict(
        jax.device_get(tok.ssl_variables), ssl_cfg)))
    return BiCodecTokenizer(m, ssl).eval()


def tiny_train_unise_jax():
    """A tiny UniSE that can train: the tokenizing BiCodec over the tiny
    XLSR, the tiny WavLM and LM of :func:`tiny_unise_jax`."""
    from unified_audio_tpu.models.unise.model import UniSE, UniSEConfig

    wavlm_cfg = tiny_wavlm_config()
    cfg = UniSEConfig(
        segment_seconds=0.4, feats_dim=24, global_tokens=4,
        llm=LlamaConfig(global_size=64, semantic_size=64, hidden_size=32,
                        num_layers=2, num_heads=4),
    )
    _, sft_vars = jax_sft(cfg.llm, cfg.feats_dim, seed=3)
    return UniSE(cfg, jax_tokenizer(), wavlm_cfg,
                 wavlm_variables(wavlm_cfg), sft_params=sft_vars)


def port_unise(unise):
    """The port's UniSE (fp32, CPU) with the JAX UniSE's weights."""
    from unified_audio_tpu_torch.models.bicodec.tokenizer import (
        BiCodecTokenizer)
    from unified_audio_tpu_torch.models.unise import model as t_unise

    cfg = unise.config
    t_cfg = t_unise.UniSEConfig(
        **{**dataclasses.asdict(cfg), "llm": port_config(cfg.llm)})
    sft = port_sft(cfg.llm, jax.device_get(unise.sft_params), cfg.feats_dim)
    tok = (port_tokenizer(unise.tokenizer)
           if unise.tokenizer.ssl_variables is not None else
           BiCodecTokenizer(port_bicodec(unise.tokenizer.config,
                                         unise.tokenizer.variables)))
    return t_unise.UniSE(
        t_cfg, tok, port_wavlm(unise.wavlm.config, unise.wavlm_variables),
        sft)


class TestPortImportsNoJax:
    def test_cli_imports_without_jax(self):
        """With jax and flax made unimportable, the port's CLI (and through
        it the serving path, the SS cascade, offline enhancement, the
        evaluation modules, the bf16 precision helper and the HCodec round
        trips), HCodec-1.5 adaptive and FlexiCodec with the Mimi
        transformer, the fbank frontend and the SAN-M teacher, the
        UniTok pipeline and engine, the step profiler, CodecLM
        pretraining with its token corpus, the training
        modules (the UniSE and codec trainers, the discriminators,
        checkpoints, both data pipelines, config, logging) and the
        parallel ones (process start-up, meshes, the pipeline, the
        sequence-parallel prefill), and the last slice's modules (the
        conformer, the native loader, the profiling, token-map and
        watchdog utilities, the ring-KV streaming transformer, GRVQ) still
        import, and no module of the JAX package is loaded."""
        code = ("import sys; sys.modules['jax'] = None; "
                "sys.modules['flax'] = None; "
                "import unified_audio_tpu_torch.cli, "
                "unified_audio_tpu_torch.serve.engine, "
                "unified_audio_tpu_torch.serve.cascade, "
                "unified_audio_tpu_torch.models.unise.model, "
                "unified_audio_tpu_torch.models.hcodec.tokenizer, "
                "unified_audio_tpu_torch.models.unitok.pipeline, "
                "unified_audio_tpu_torch.serve.unitok_engine, "
                "unified_audio_tpu_torch.serve.profile_step, "
                "unified_audio_tpu_torch.utils.convert, "
                "unified_audio_tpu_torch.utils.initialization, "
                "unified_audio_tpu_torch.train.sft_trainer, "
                "unified_audio_tpu_torch.train.codec_trainer, "
                "unified_audio_tpu_torch.train.discriminators, "
                "unified_audio_tpu_torch.data.hcodec_data, "
                "unified_audio_tpu_torch.train.checkpoint, "
                "unified_audio_tpu_torch.data.data_module, "
                "unified_audio_tpu_torch.utils.config, "
                "unified_audio_tpu_torch.utils.logging, "
                "unified_audio_tpu_torch.utils.precision, "
                "unified_audio_tpu_torch.eval.metrics, "
                "unified_audio_tpu_torch.eval.runner, "
                "unified_audio_tpu_torch.eval.utmos, "
                "unified_audio_tpu_torch.nn.mimi, "
                "unified_audio_tpu_torch.models.hcodec.adaptive, "
                "unified_audio_tpu_torch.models.hcodec.adaptive_tokenizer, "
                "unified_audio_tpu_torch.models.hcodec.flexicodec, "
                "unified_audio_tpu_torch.models.ssl.sanm, "
                "unified_audio_tpu_torch.ops.fbank, "
                "unified_audio_tpu_torch.data.token_corpus, "
                "unified_audio_tpu_torch.train.pretrain, "
                "unified_audio_tpu_torch.parallel.distributed, "
                "unified_audio_tpu_torch.parallel.mesh, "
                "unified_audio_tpu_torch.parallel.pipeline, "
                "unified_audio_tpu_torch.parallel.sequence, "
                "unified_audio_tpu_torch.models.lm.conformer, "
                "unified_audio_tpu_torch.data.native_loader, "
                "unified_audio_tpu_torch.utils.profiling, "
                "unified_audio_tpu_torch.utils.token_parser, "
                "unified_audio_tpu_torch.utils.watchdog, "
                "unified_audio_tpu_torch.nn.streaming, "
                "unified_audio_tpu_torch.ops.grvq; "
                "shared = {m for m in sys.modules "
                "if m.split('.')[0] == 'unified_audio_tpu'}; "
                "assert not shared, shared")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr

    # The root scripts that import JAX. ``bench.py`` and
    # ``__graft_entry__.py`` are the JAX package's own. ``orbax_to_torch.py``
    # is the port's one exception: it reads the JAX package's orbax
    # checkpoints, which only orbax can, and writes torch files; it runs
    # where JAX is installed, never on the card, and nothing of the port
    # imports it.
    JAX_ROOT_SCRIPTS = {"bench.py", "__graft_entry__.py", "orbax_to_torch.py"}

    @classmethod
    def _port_sources(cls):
        files = list((REPO / "unified_audio_tpu_torch").rglob("*.py"))
        return files + [f for f in REPO.glob("*.py")
                        if f.name not in cls.JAX_ROOT_SCRIPTS]

    def test_every_jax_module_has_a_port(self):
        """A diff of the two packages' module lists leaves only the JAX
        files that ROADMAP.md "Not ported" names: the Pallas kernels (the
        port's are ``ops/cuda/*`` over ``csrc/*``), the TPU parameter
        packing and the two reference-layout converters."""
        def modules(pkg):
            root = REPO / pkg
            return {str(f.relative_to(root)) for f in root.rglob("*.py")}

        missing = modules("unified_audio_tpu") - modules(
            "unified_audio_tpu_torch")
        assert missing == {
            "ops/pallas/__init__.py", "ops/pallas/paged_attention.py",
            "ops/pallas/vq_kernel.py", "utils/param_pack.py",
            "utils/convert_bicodec.py", "utils/convert_hcodec.py"}, missing

    def test_root_scripts_scanned(self):
        """The scan covers every other root script, chip_smoke.py and the
        scripts beside it among them."""
        names = {f.name for f in self._port_sources()
                 if f.parent == REPO}
        assert {"chip_smoke.py", "compare_trees.py", "profiler_windows.py",
                "profile_serve.py", "smoke_phases.py"} <= names
        assert not names & self.JAX_ROOT_SCRIPTS

    def test_only_the_converter_reaches_orbax(self):
        """``orbax_to_torch.py`` imports JAX and orbax only inside its
        functions (importing the script loads neither), and no port module
        imports the script."""
        src = (REPO / "orbax_to_torch.py").read_text().splitlines()
        top = [ln for ln in src if re.match(
            r"(import|from)\s+(jax|flax|orbax|unified_audio_tpu)\b", ln)]
        assert not top, top
        assert any("from unified_audio_tpu.train.checkpoint import" in ln
                   for ln in src)
        for f in (REPO / "unified_audio_tpu_torch").rglob("*.py"):
            assert not re.search(r"^\s*(import|from)\s+orbax_to_torch\b",
                                 f.read_text(), re.M), f

    def test_no_jax_import_lines(self):
        """No module of the port, nor chip_smoke.py and the scripts beside it,
        has an import line naming jax or flax."""
        for f in self._port_sources():
            for line in f.read_text().splitlines():
                s = line.strip()
                assert not (s.startswith(("import jax", "from jax",
                                          "import flax", "from flax"))), \
                    f"{f}: {line}"

    def test_no_jax_package_import_lines(self):
        """No module of the port, nor chip_smoke.py and the scripts beside it,
        imports the JAX package (``unified_audio_tpu`` not followed by ``_torch``), not even
        a numpy-only module of it."""
        pattern = re.compile(
            r"^\s*(import|from)\s+unified_audio_tpu(?!_torch)\b")
        for f in self._port_sources():
            for line in f.read_text().splitlines():
                assert not pattern.match(line), f"{f}: {line}"
