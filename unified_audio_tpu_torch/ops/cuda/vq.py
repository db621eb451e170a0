"""VQ nearest-code search: CUDA kernels and plain versions.

Port of ``unified_audio_tpu/ops/pallas/vq_kernel.py``:

* K5 :func:`nearest_code` (TPU kernel ``nearest_code_pallas``): one
  codebook, x (M, D) fp32, codebook (N, D) fp32 -> (M,) int32;
* K6 :func:`rvq_encode_fused` (``rvq_encode_fused_pallas``): all nq residual
  layers in one launch, codebooks (nq, N, D) -> (M, nq) int32;
* :func:`rvq_encode_staged` (``rvq_encode_pallas``): a host loop of K5.

The code of a row is ``argmin_j(|e_j|^2 - 2 x . e_j)`` in fp32, ties to the
lowest j, the semantics of ``ops/quant.py nearest_code`` in the JAX package.
The kernels are CUDA C++ for sm_90a in ``csrc/vq.cu``, built with ``nvcc``
on first use (``ops/cuda/build.py``). Each wrapper launches its kernel for
CUDA tensors and uses the plain PyTorch version beside it only for tensors
on the CPU; there is no fallback from a failed launch. Each wrapper counts
its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

MAX_DIM = 4096  # the residual tile (8 rows x D fp32) lives in shared memory


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the reference the kernels are held against)
# ---------------------------------------------------------------------------

def nearest_code_ref(x, codebook):
    """Plain K5: ``|e|^2 - 2 x @ e^T`` in fp32, then argmin (the first of
    equal minima)."""
    cb = codebook.float()
    dist = cb.square().sum(-1) - 2.0 * (x.float() @ cb.T)
    return dist.argmin(-1).int()


def rvq_encode_fused_ref(x, codebooks):
    """Plain K6: the residual layer loop, each layer subtracting the exact
    codebook row it chose."""
    residual = x.float()
    codes = []
    for cb in codebooks:
        idx = nearest_code_ref(residual, cb)
        residual = residual - cb.float()[idx.long()]
        codes.append(idx)
    return torch.stack(codes, -1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _library():
    from .build import load_library

    lib = load_library("vq.cu")
    if not getattr(lib, "_typed", False):
        lib.vq_nearest_code_f32.argtypes = [_PTR] * 4 + [_INT] * 3 + [_PTR]
        lib.vq_rvq_encode_f32.argtypes = [_PTR] * 4 + [_INT] * 4 + [_PTR]
        lib.vq_nearest_code_f32.restype = ctypes.c_int
        lib.vq_rvq_encode_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def _require(cond: bool, what: str):
    if not cond:
        raise ValueError(f"VQ kernel: {what}")


def _check(x, codebooks):
    """codebooks (..., N, D); returns (M, N, D)."""
    dev = x.device
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(x.dim() == 2, f"x must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    n = codebooks.shape[-2]
    _require(codebooks.shape[-1] == d,
             f"codebook dim {codebooks.shape[-1]} != x dim {d}")
    _require(m > 0 and n > 0, f"empty input: M={m}, N={n}")
    _require(d % 16 == 0 and d <= MAX_DIM,
             f"D={d} unsupported: a multiple of 16 up to {MAX_DIM}")
    for name, t in (("x", x), ("codebook", codebooks)):
        _require(t.dtype == torch.float32, f"{name} must be fp32, got "
                 f"{t.dtype}")
        _require(t.device == dev, f"{name} on {t.device}, x on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        # the kernel reads rows with 16-byte vector loads
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    return m, n, d


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def nearest_code(x, codebook):
    """K5: x (M, D) fp32, codebook (N, D) fp32 -> codes (M,) int32."""
    if x.device.type == "cpu":
        return nearest_code_ref(x, codebook)
    _require(codebook.dim() == 2, f"codebook must be (N, D), got "
             f"{tuple(codebook.shape)}")
    m, n, d = _check(x, codebook)
    cbsq = codebook.square().sum(-1)
    out = torch.empty(m, dtype=torch.int32, device=x.device)
    rc = _library().vq_nearest_code_f32(
        x.data_ptr(), codebook.data_ptr(), cbsq.data_ptr(), out.data_ptr(),
        m, n, d, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "nearest_code")
    nearest_code.launches += 1
    return out


def rvq_encode_fused(x, codebooks):
    """K6: x (M, D) fp32, codebooks (nq, N, D) fp32 -> codes (M, nq) int32,
    all layers in one launch."""
    if x.device.type == "cpu":
        return rvq_encode_fused_ref(x, codebooks)
    _require(codebooks.dim() == 3, f"codebooks must be (nq, N, D), got "
             f"{tuple(codebooks.shape)}")
    m, n, d = _check(x, codebooks)
    nq = codebooks.shape[0]
    cbsq = codebooks.square().sum(-1)
    out = torch.empty(m, nq, dtype=torch.int32, device=x.device)
    rc = _library().vq_rvq_encode_f32(
        x.data_ptr(), codebooks.data_ptr(), cbsq.data_ptr(), out.data_ptr(),
        m, n, d, nq, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "rvq_encode_fused")
    rvq_encode_fused.launches += 1
    return out


nearest_code.launches = 0
rvq_encode_fused.launches = 0


def rvq_encode_staged(x, codebooks):
    """The residual layer loop on the host, one K5 launch per layer:
    x (M, D), codebooks (nq, N, D) -> (M, nq) int32."""
    residual = x
    codes = []
    for cb in codebooks:
        idx = nearest_code(residual, cb)
        residual = residual - cb[idx.long()]
        codes.append(idx)
    return torch.stack(codes, -1)


# ---------------------------------------------------------------------------
# Codes against the plain search (card tests and chip_smoke.py)
# ---------------------------------------------------------------------------

def judge_codes(x, codebooks, codes, rel_tol: float = 1e-5):
    """Hold ``codes`` (M, nq) of x (M, D) against the plain search, layer by
    layer: layer l's codes are compared with ``nearest_code_ref`` of the
    residual built from ``codes``' own layers < l. A row that differs must be
    a near tie: its distance (in fp64) exceeds that of the plain code by at
    most ``rel_tol * (|x|^2 + max |e|^2)``, another summation order's
    rounding.

    Returns (share of (row, layer) codes equal to the plain ones, largest
    distance excess over the plain code (0.0 where all agree), every
    differing code a near tie)."""
    residual = x.float()
    agree, worst, ok = 0, 0.0, True
    for l, cb in enumerate(codebooks):
        got = codes[:, l].long()
        want = nearest_code_ref(residual, cb).long()
        same = got == want
        agree += int(same.sum())
        if not bool(same.all()):
            r64, cb64 = residual[~same].double(), cb.double()
            dist = lambda idx: (cb64[idx].square().sum(-1)
                                - 2.0 * (r64 * cb64[idx]).sum(-1))
            excess = dist(got[~same]) - dist(want[~same])
            limit = rel_tol * (r64.square().sum(-1)
                               + cb64.square().sum(-1).max())
            worst = max(worst, float(excess.max()))
            ok = ok and bool((excess <= limit).all())
        residual = residual - cb.float()[got]
    return agree / codes.numel(), worst, ok


def random_case(m: int, n: int = 1024, d: int = 512, nq: int = 4,
                device="cuda", seed: int = 0):
    """fp32 normal rows (M, D) and codebooks (nq, N, D) from a seed."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, d, generator=g)
    cbs = torch.randn(nq, n, d, generator=g)
    return x.to(device), cbs.to(device)
