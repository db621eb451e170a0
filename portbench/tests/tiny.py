"""Tiny versions of the benchmark's configurations and cells, for the CPU
tests: the same files' keys at widths a test run holds."""
from __future__ import annotations

import copy
import json
from argparse import Namespace
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    if name == "unise":
        cfg["lm"].update(global_size=64, semantic_size=64, hidden_size=32,
                         num_layers=2, num_heads=4)
        cfg["unise"].update(segment_seconds=0.4, feats_dim=24,
                            global_tokens=4)
        cfg["wavlm"].update(hidden_size=24, num_layers=2, num_heads=4,
                            intermediate_size=32, conv_dim=[16] * 7,
                            num_conv_pos_embeddings=16,
                            num_conv_pos_embedding_groups=4, num_buckets=32,
                            max_distance=80)
        cfg["xlsr"].update(hidden_size=16, num_layers=17, num_heads=2,
                           intermediate_size=32, conv_dim=[16] * 7,
                           num_conv_pos_embeddings=16,
                           num_conv_pos_embedding_groups=4)
        cfg["bicodec"].update(
            ref_segment_duration=0.2, feat_dim=16, vocos_dim=32,
            vocos_intermediate_dim=64, vocos_num_layers=1, latent_dim=32,
            codebook_size=64, codebook_dim=8, spk_out_dim=32,
            spk_latent_dim=16, token_num=4, fsq_levels=[4, 4, 4],
            num_mels=32, mel_n_fft=256, mel_win=160, mel_hop=80,
            wave_channels=32)
    elif name == "hcodec10":
        cfg["hcodec"].update(latent_dim=64, seanet_filters=4,
                             codebook_size=32, num_quantizers=2,
                             decoder_dim=64, decoder_intermediate_dim=128,
                             decoder_convnext_layers=2, feat_dim=32,
                             semantic_encode_channels=64)
        cfg["hubert"].update(hidden_size=32, num_layers=2, num_heads=4,
                             intermediate_size=32, conv_dim=[16] * 7,
                             num_conv_pos_embeddings=16,
                             num_conv_pos_embedding_groups=4)
    return cfg


def cell(name: str) -> dict:
    c = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    if "traffic" in c and c["driver"] == "unise_serve":
        c["slots"] = 8
        c["traffic"].update(clients=12, block=12, min_seconds=0.1,
                            max_seconds=1.0, enroll_seconds=0.4,
                            bank_clips=4)
        c["check"].update(min_tokens=10)
        c["warm_waves"] = 1
    elif c["driver"] == "unise_train":
        c["first_steps"] = 6
        c["dataset"].update(batch_size=2, cut_duration=[0.4, 0.4],
                            enroll_duration=0.4, num_workers=2, prefetch=2)
        c["corpus"].update(speakers=2, utterances=2, speech_seconds=0.6,
                           noises=1, noise_seconds=1.0, rirs=1,
                           rir_seconds=0.1)
    elif c["driver"] == "hcodec_roundtrip":
        c["traffic"].update(batch=2, clip_seconds=0.16, bank_batches=2)
    return c


def run(name: str, seed: int = 3, seconds: float = 0.0, trace: int = 0):
    """A ``Run`` of cell ``name`` on the CPU at the tiny sizes."""
    import torch

    from portbench.harness import manifest
    from portbench.harness.context import Run

    bench = manifest.load_manifest()
    entry = manifest.entry(bench["workloads"], name, "workload")
    ref = manifest.load_module(manifest.reference_path(entry["config"]),
                               "reference." + entry["config"])
    args = Namespace(seed=seed, seconds=seconds, trace=trace)
    return Run(torch, args, cell(name), config(entry["config"]), entry, ref,
               device="cpu")
