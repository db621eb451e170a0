#!/usr/bin/env python3
"""Time the CUDA kernels of several source trees on one CUDA card, in turns.

    python3 compare_trees.py NAME=DIR ...
        [--kernels K1 K4 K5 K6] [--q bf16 fp32] [--vq-m 250 2000]
        [--no-check] [--out RESULT.json]

A developer's tool beside ``chip_smoke.py``, whose timer it uses; nothing
in the package runs it. Run from the repository root. Each DIR is a checkout of the repository
(for example a ``git archive`` of another commit).

Decode kernels (K1-K4, K7): each tree's
``unified_audio_tpu_torch/csrc/paged_attention.cu`` is built with this
checkout's nvcc flags and called through this checkout's wrappers, which
take every tree's C interface. Cases: K1 and K2 at ``serving_case``, K3
and K4 at ``stream_serving_case``, K7 at ``table_serving_case``, each with
bf16 and fp32 q. Each tree's kernel is first held against the plain
version (``compare_with_plain``; ``--no-check`` skips it); then the trees are timed warm (100 calls
on layer 7) and cold (the layer cycling 0..11, each call finding its layer
out of L2), in the order t0, t1, ..., t1, t0, by ``chip_smoke.time_ms``:
device time from torch.profiler's records, counted by name, one decode
kernel record a call.

VQ kernels (K5 one codebook, K6 four residual layers): each tree's
``csrc/vq.cu`` is built the same way and called through this checkout's
wrapper when it has the cluster kernel's C interface (``vq_search_f32``),
else as the earlier wrapper called it (stacked codebooks and their
``|e|^2``, computed in the call, as that wrapper did). At M = 250 (one
10-s clip) and 2000 rows, or the row counts of ``--vq-m`` (N = 1024,
D = 512, random rows and codebooks from a seed), each tree's codes are
held against the plain search by ``vq.judge_codes`` (>= 99.9% equal,
every other a near tie; ``--no-check`` skips it), then the trees are
timed in turns, 50 calls a window, one ``vq_search_kernel`` record a
call. Two builds of one design that differ in a constant are two trees,
one a copy of the other with the constant edited in its ``csrc/vq.cu``.

Prints the card's name and power limit, then one JSON line per (kernel,
dtype or M), and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke

CASES = {  # kernel -> (wrapper, plain version, case builder, layer position)
    "K1": ("paged_flash_decode_owner", "paged_flash_decode_owner_ref",
           lambda pa, dt: pa.serving_case(False, dt, "cuda"), -1),
    "K2": ("paged_flash_decode_owner_q8", "paged_flash_decode_owner_q8_ref",
           lambda pa, dt: pa.serving_case(True, dt, "cuda"), -1),
    "K3": ("paged_flash_decode_stream_flat",
           "paged_flash_decode_stream_flat_ref",
           lambda pa, dt: pa.stream_serving_case(False, dt, "cuda"), -2),
    "K4": ("paged_flash_decode_stream_flat_q8",
           "paged_flash_decode_stream_flat_q8_ref",
           lambda pa, dt: pa.stream_serving_case(True, dt, "cuda"), -2),
    "K7": ("paged_flash_decode", "paged_flash_decode_ref",
           lambda pa, dt: pa.table_serving_case(dt, "cuda"), -1),
}
VQ_CASES = {"K5": 1, "K6": 4}  # kernel -> residual layers
VQ_ROWS = [250, 2000]  # M of the VQ cases: one clip, eight


def vq_caller(vq, lib, nq):
    """-> call(x, codebooks) through ``lib``: this checkout's wrapper for
    the cluster kernel's C interface, else the earlier wrapper's call."""
    if hasattr(lib, "vq_search_f32"):
        lib = vq.typed(lib)
        fn = vq.nearest_code if nq == 1 else vq.rvq_encode_fused

        def call(x, cbs):
            own = vq._library
            vq._library = lambda: lib
            try:
                return fn(x, cbs[0])[:, None] if nq == 1 else fn(x, cbs)
            finally:
                vq._library = own
        return call
    import ctypes

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vq_nearest_code_f32.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.vq_rvq_encode_f32.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]

    def call(x, cbs):
        m, d = x.shape
        cbsq = cbs.square().sum(-1)
        out = torch.empty(m, nq, dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), cbs.data_ptr(), cbsq.data_ptr(),
                out.data_ptr(), m, cbs.shape[1], d)
        rc = (lib.vq_nearest_code_f32(*args, stream) if nq == 1 else
              lib.vq_rvq_encode_f32(*args, nq, stream))
        if rc != 0:
            raise RuntimeError(f"vq launch failed with error {rc}")
        return out
    return call


def compare_vq(args, gpu, kid):
    """K5 or K6 of every tree, checked and timed in turns at each M."""
    from unified_audio_tpu_torch.ops.cuda import vq
    from unified_audio_tpu_torch.ops.cuda.build import load_library

    nq = VQ_CASES[kid]
    names, calls = [], []
    for spec in args.trees:
        name, _, root = spec.partition("=")
        lib = load_library(Path(root).resolve() / "unified_audio_tpu_torch"
                           / "csrc" / "vq.cu")
        names.append(name)
        calls.append(vq_caller(vq, lib, nq))
    records = []
    for m in args.vq_m:
        x, cbs = vq.random_case(m, **chip_smoke.VQ_SHAPES, seed=m)
        cbs = cbs[:nq].contiguous()
        judged = {n: None for n in names}
        for name, call in zip(names, [] if args.no_check else calls):
            codes = call(x, cbs)
            torch.cuda.synchronize()
            share, worst, ok = vq.judge_codes(x, cbs, codes)
            if not (share >= 0.999 and ok):
                sys.exit(f"compare_trees: {name} {kid} at M={m}: {share:.5f}"
                         f" of codes equal, worst excess {worst:.3e}")
            judged[name] = (share, worst)
        warm = chip_smoke.in_turns(
            torch, [lambda c=c: c(x, cbs) for c in calls], iters=50,
            kernels=[chip_smoke.CUDA_KERNELS["vq"]] * len(names))
        rec = {"kernel": kid, "m": m, "gpu": gpu,
               "trees": {n: {"warm_us": 1e3 * w["ms"],
                             "records": w["records"],
                             "share_equal": None if judged[n] is None
                             else judged[n][0],
                             "worst_excess": None if judged[n] is None
                             else judged[n][1]}
                         for n, w in zip(names, warm)}}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", help="NAME=DIR of a checkout")
    ap.add_argument("--kernels", nargs="+", default=["K1", "K4"],
                    choices=sorted(CASES) + sorted(VQ_CASES))
    ap.add_argument("--q", nargs="+", default=["bf16", "fp32"],
                    choices=["bf16", "fp32"], help="q dtypes to time")
    ap.add_argument("--vq-m", nargs="+", type=int, default=VQ_ROWS,
                    help="rows M of the K5/K6 cases")
    ap.add_argument("--no-check", action="store_true",
                    help="time without holding the kernels to the plain "
                    "versions (builds that compute wrong values on purpose)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_trees: needs a CUDA card")
    from unified_audio_tpu_torch.ops.cuda import paged_attention as pa
    from unified_audio_tpu_torch.ops.cuda.build import load_library

    gpu = chip_smoke.gpu_line()
    print(gpu, flush=True)
    records = []
    for kid in [k for k in args.kernels if k in VQ_CASES]:
        records += compare_vq(args, gpu, kid)
    libs = {}
    for spec in args.trees if set(args.kernels) & set(CASES) else []:
        name, _, root = spec.partition("=")
        src = Path(root).resolve() / "unified_audio_tpu_torch" / "csrc" / \
            "paged_attention.cu"
        libs[name] = pa.typed(load_library(src))
    names = list(libs)
    for kid in [k for k in args.kernels if k in CASES]:
        wrapper, ref_name, case, li_pos = CASES[kid]
        kernel, ref = getattr(pa, wrapper), getattr(pa, ref_name)
        for dtype in [{"bf16": torch.bfloat16, "fp32": torch.float32}[q]
                      for q in args.q]:
            call_args = case(pa, dtype)
            empty = ((~(call_args[-3] != 0).any(1)) if kid in ("K3", "K4")
                     else None)

            def through(lib, layer=None):
                def call(*_):
                    a = call_args if layer is None else \
                        chip_smoke.at_layer(call_args, li_pos, layer)
                    own = pa._library
                    pa._library = lambda: lib
                    try:
                        return kernel(*a)
                    finally:
                        pa._library = own
                return call

            errs = {name: None for name in names}
            for name in names if not args.no_check else []:
                err, ok = pa.compare_with_plain(through(libs[name]), ref,
                                                call_args, empty)
                if not ok:
                    sys.exit(f"compare_trees: {name} {kid} {dtype}: max abs "
                             f"err {err} outside tolerance")
                errs[name] = err
            warm = chip_smoke.in_turns(
                torch, [through(libs[n]) for n in names],
                kernels=["_decode_kernel"] * len(names))
            cold = chip_smoke.in_turns(
                torch, [chip_smoke.cycling(
                    lambda li, lib=libs[n]: through(lib, li)())
                    for n in names],
                kernels=["_decode_kernel"] * len(names))
            rec = {"kernel": kid, "q": str(dtype)[6:], "gpu": gpu,
                   "trees": {n: {"warm_us": 1e3 * w["ms"],
                                 "cold_us": 1e3 * c["ms"],
                                 "records": w["records"] + c["records"],
                                 "max_abs_err": errs[n]}
                             for n, w, c in zip(names, warm, cold)}}
            print(json.dumps(rec), flush=True)
            records.append(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
