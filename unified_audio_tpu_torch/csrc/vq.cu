// Vector-quantizer nearest-code search for Hopper (sm_90a).
//
// Replaces the TPU kernels in unified_audio_tpu/ops/pallas/vq_kernel.py:
//   K5  nearest_code_pallas      (_nn_kernel):  one codebook
//   K6  rvq_encode_fused_pallas  (_rvq_kernel): all nq residual layers in one
//       launch
//
// What it computes. For each row x_i of x (M, D) fp32 and a codebook E (N, D)
// fp32, code_i = argmin_j (|e_j|^2 - 2 x_i . e_j), ties to the lowest j (|x|^2
// does not move the argmin; |e_j|^2 comes in precomputed, fp32, as the JAX
// wrapper computes it). K6 runs the search nq times: after layer l the
// residual subtracts the exact fp32 codebook row it chose (a gather), which
// is what ResidualVQ.encode computes. The TPU kernel's one-hot matmul for that
// step was a device for the MXU and rounds at its default precision; it has
// no counterpart here.
//
// Arithmetic. fp32 FMA on the CUDA cores, no TF32 and no tensor cores: the
// JAX reference pins Precision.HIGHEST, and a TF32 dot flips near-tie codes.
// Each thread sums x . e over D in order, so a code can differ from another
// fp32 summation order only where two distances tie to within rounding.
//
// What bounds it on this card. 2 * nq * M * N * D operations against
// (M * D + nq * N * D) * 4 bytes: at M = 250, N = 1024, D = 512, nq = 4 that is
// 1.05 GFLOP (about 16 us at the data sheet's 67 TFLOP/s fp32) against 8.9 MB
// (about 2.7 us at 3.35 TB/s), so the work is compute-bound.
//
// Design. One block of 128 threads per tile of 8 rows. The rows' residual
// (8 x D fp32, 16 KB at D = 512) stays in shared memory for all nq layers. The
// block walks the codebook in tiles of 512 codes x 16 dims staged in shared
// memory, the next slice loaded into registers (coalesced, 64 bytes per row)
// while the current one is computed; each thread owns 4 consecutive codes of
// a tile against all 8 rows, so one 16-byte code load feeds 32 FMAs and the
// rows are read as broadcasts.
// Each thread keeps a running (best distance, best code) per row with a
// strict < over ascending codes; the 128 candidates per row then reduce
// through warp shuffles and shared memory, lower code first on equal
// distance. Ragged M is masked: no padding of the rows.
//
// Known limit. The layer chain needs every code of a layer before the next
// layer starts, so a block walks the whole codebook: at M = 250 only 32
// blocks run on 132 SMs. Splitting the codebook across a thread block
// cluster (with a distributed-shared-memory argmin) or across more rows per
// launch (batching clips) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;                                 // rows per block
constexpr int kThreads = 128;                            // 4 warps
constexpr int kCodesPerThread = 4;                       // one float4
constexpr int kTileCodes = kThreads * kCodesPerThread;   // 512 codes
constexpr int kTileDepth = 16;                           // dims per stage
constexpr int kTileStride = kTileCodes + 4;  // 2-way bank conflicts on store
constexpr int kLoads = kTileCodes * kTileDepth / 4 / kThreads;  // float4s
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float d2, int i2, float d1, int i1) {
  return d2 < d1 || (d2 == d1 && i2 < i1);
}

size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(d) * kRows +
                          kTileDepth * kTileStride + kWarps * kRows) +
         sizeof(int) * (kWarps * kRows + kRows);
}

// One stage's slice of the codebook, tile rows [base, base + kTileCodes) x
// dims [k0, k0 + kTileDepth), into registers: four neighbouring threads read
// one row's 64 contiguous bytes, a warp 8 rows. Rows past n read zeros.
__device__ __forceinline__ void load_stage(float4 (&pre)[kLoads],
                                           const float* __restrict__ book,
                                           int n, int d, int base, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = t + kThreads * i, j = base + (e >> 2);
    pre[i] = j < n ? __ldg(reinterpret_cast<const float4*>(
                         book + static_cast<size_t>(j) * d + k0 + 4 * (e & 3)))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// x (m, d); cb (nq, n, d); cbsq (nq, n); codes (m, nq) int32, row-major.
__global__ void __launch_bounds__(kThreads)
vq_search_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                 const float* __restrict__ cbsq, int* __restrict__ codes,
                 int m, int n, int d, int nq) {
  extern __shared__ float smem[];
  float* xs = smem;                                   // [d][kRows] residual
  float* tile = xs + static_cast<size_t>(d) * kRows;  // [kTileDepth][kTileStride]
  float* red_d = tile + kTileDepth * kTileStride;     // [kWarps][kRows]
  int* red_i = reinterpret_cast<int*>(red_d + kWarps * kRows);
  int* best_row = red_i + kWarps * kRows;             // [kRows]

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, m - row0);

  for (int e = t; e < kRows * d; e += kThreads) {
    const int r = e / d, k = e - r * d;
    xs[k * kRows + r] = r < rows ? x[static_cast<size_t>(row0 + r) * d + k]
                                 : 0.f;
  }

  for (int l = 0; l < nq; ++l) {
    const float* book = cb + static_cast<size_t>(l) * n * d;
    const float* booksq = cbsq + static_cast<size_t>(l) * n;
    float best_d[kRows];
    int best_i[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      best_d[r] = INFINITY;
      best_i[r] = 0;
    }

    // stages walk the codebook tile by tile, each tile over D in
    // kTileDepth slices; the next stage's slice is loaded into registers
    // while the current one is computed
    const int k_stages = d / kTileDepth;
    const int stages = (n + kTileCodes - 1) / kTileCodes * k_stages;
    float4 pre[kLoads];
    load_stage(pre, book, n, d, 0, 0);
    float acc[kRows][kCodesPerThread];
    for (int s = 0; s < stages; ++s) {
      const int base = s / k_stages * kTileCodes;
      const int k0 = s % k_stages * kTileDepth;
      if (k0 == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int q = 0; q < kCodesPerThread; ++q) acc[r][q] = 0.f;
      }
      __syncthreads();  // the previous stage is consumed; xs is written
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int e = t + kThreads * i, code = e >> 2, quad = e & 3;
        float* col = tile + 4 * quad * kTileStride + code;
        col[0] = pre[i].x;
        col[kTileStride] = pre[i].y;
        col[2 * kTileStride] = pre[i].z;
        col[3 * kTileStride] = pre[i].w;
      }
      __syncthreads();
      if (s + 1 < stages)
        load_stage(pre, book, n, d, (s + 1) / k_stages * kTileCodes,
                   (s + 1) % k_stages * kTileDepth);
#pragma unroll
      for (int kk = 0; kk < kTileDepth; ++kk) {
        const float4 c = *reinterpret_cast<const float4*>(
            tile + kk * kTileStride + t * kCodesPerThread);
        const float4 xa =
            *reinterpret_cast<const float4*>(xs + (k0 + kk) * kRows);
        const float4 xb =
            *reinterpret_cast<const float4*>(xs + (k0 + kk) * kRows + 4);
        const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w,
                                 xb.x, xb.y, xb.z, xb.w};
        const float cv[kCodesPerThread] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int q = 0; q < kCodesPerThread; ++q)
            acc[r][q] = fmaf(xv[r], cv[q], acc[r][q]);
      }
      if (k0 + kTileDepth == d) {
#pragma unroll
        for (int q = 0; q < kCodesPerThread; ++q) {
          const int j = base + t * kCodesPerThread + q;
          if (j < n) {
            const float sq = booksq[j];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float dist = sq - 2.f * acc[r][q];
              if (dist < best_d[r]) {
                best_d[r] = dist;
                best_i[r] = j;
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float dd = best_d[r];
      int ii = best_i[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float d2 = __shfl_down_sync(0xffffffffu, dd, off);
        const int i2 = __shfl_down_sync(0xffffffffu, ii, off);
        if (better(d2, i2, dd, ii)) {
          dd = d2;
          ii = i2;
        }
      }
      if (lane == 0) {
        red_d[warp * kRows + r] = dd;
        red_i[warp * kRows + r] = ii;
      }
    }
    __syncthreads();
    if (t < kRows) {
      float dd = red_d[t];
      int ii = red_i[t];
      for (int w = 1; w < kWarps; ++w) {
        if (better(red_d[w * kRows + t], red_i[w * kRows + t], dd, ii)) {
          dd = red_d[w * kRows + t];
          ii = red_i[w * kRows + t];
        }
      }
      best_row[t] = ii;
      if (t < rows) codes[static_cast<size_t>(row0 + t) * nq + l] = ii;
    }
    __syncthreads();
    if (l + 1 < nq) {
      // residual -= the chosen codebook row, exact fp32 (a gather)
      for (int e = t; e < rows * d; e += kThreads) {
        const int r = e / d, k = e - r * d;
        xs[k * kRows + r] -= book[static_cast<size_t>(best_row[r]) * d + k];
      }
    }
  }
}

int launch(const void* x, const void* cb, const void* cbsq, void* codes,
           int m, int n, int d, int nq, void* stream) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      vq_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kRows - 1) / kRows);
  vq_search_kernel<<<grid, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const float*>(cbsq), static_cast<int*>(codes), m, n, d, nq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError().
extern "C" {

int vq_smem_bytes(int d) { return static_cast<int>(smem_bytes(d)); }

// K5: x (m, d), cb (n, d), cbsq (n,) -> codes (m,)
int vq_nearest_code_f32(const void* x, const void* cb, const void* cbsq,
                        void* codes, int m, int n, int d, void* stream) {
  return launch(x, cb, cbsq, codes, m, n, d, 1, stream);
}

// K6: x (m, d), cbs (nq, n, d), cbsq (nq, n) -> codes (m, nq)
int vq_rvq_encode_f32(const void* x, const void* cbs, const void* cbsq,
                      void* codes, int m, int n, int d, int nq, void* stream) {
  return launch(x, cbs, cbsq, codes, m, n, d, nq, stream);
}

}  // extern "C"
