// Vector-quantizer nearest-code search for Hopper (sm_90a).
//
// Replaces the TPU kernels in unified_audio_tpu/ops/pallas/vq_kernel.py:
//   K5  nearest_code_pallas      (_nn_kernel):  one codebook
//   K6  rvq_encode_fused_pallas  (_rvq_kernel): all nq residual layers in one
//       launch
// Both launch the one kernel below, once per call (nq = 1 for K5).
//
// What it computes. For each row x_i of x (M, D) fp32 and a codebook E (N, D)
// fp32, code_i = argmin_j (|e_j|^2 - 2 x_i . e_j), ties to the lowest j (|x|^2
// does not move the argmin). K6 runs the search nq times: after layer l the
// residual subtracts the exact fp32 codebook row it chose (a gather), which
// is what ResidualVQ.encode computes. The TPU kernel's one-hot matmul for that
// step was a device for the MXU and rounds at its default precision; it has
// no counterpart here.
//
// Arithmetic. The dot products run on the tensor cores as 3xTF32: each
// fp32 operand is split into hi = tf32(v) and lo = tf32(v - hi), and
// x . e = lo_x hi_e + hi_x lo_e + hi_x hi_e, summed in fp32 by mma.sync
// (m16n8k8, .tf32); the dropped lo_x lo_e term and the tensor cores' own
// summation move a distance by about 2^-22 of sum |x_k e_k|. Plain TF32 (hi
// alone, a 10-bit mantissa) would move it by ~1e-2 at D = 512 and flip
// near-tie codes, which the JAX reference (Precision.HIGHEST) does not.
// |e_j|^2 is summed in fp32 on the CUDA cores, by the same plan for every
// code, so two equal codebook rows get equal distances and an exact tie goes
// to the lower code wherever the two rows lie; a code can differ from the
// plain fp32 search only where two distances tie to within rounding.
//
// What bounds it on this card. 2 * nq * M * N * D operations against
// (M * D + nq * N * D) * 4 bytes: at M = 250, N = 1024, D = 512, nq = 4 that is
// 1.05 GFLOP, three TF32 products each (3.1 GFLOP, about 6.4 us at the data
// sheet's 495 TFLOP/s dense TF32; 16 us at 67 TFLOP/s fp32 on the CUDA
// cores) against 8.9 MB (about 2.7 us at 3.35 TB/s): compute-bound, and one
// clip must use the card. The tensor cores, not the CUDA cores: fp32 FMA
// on a 4 x 4 register tile a thread is bound by shared-memory bandwidth (one
// distinct and one broadcast 16-byte load per 16 FMAs) at about a quarter
// of the fp32 peak on an H100, where the tensor cores read an operand word
// per 16 products a lane.
//
// Design. The codebook is split across a thread block cluster of kCluster
// CTAs: a cluster owns R rows (16 or 32: one or two m16 tiles), each of its
// CTAs a contiguous chunk of ceil(N / kCluster) codes. R is the wrapper's
// pick: 16 if the card holds all ceil(M / 16) clusters at once (15 clusters
// of 8 on an H100 at one CTA an SM: M <= 240, where 16 rows take ~27% less
// time than 32), else 32, so one 10-s clip (M = 250) runs as 8 clusters of
// 32 rows in one wave. Inside a CTA (8 warps):
// * the R residual rows stay in shared memory for all nq layers;
// * the chunk is walked in tiles of 128 codes x kDepth dims (16 KB), each
//   loaded by one TMA copy (thread 0 issues it; the slot's mbarrier counts
//   its bytes) into a ring of kStages slots, 128-byte swizzled; one barrier
//   per stage frees the slot the next copy reuses. The stage sequence runs
//   on across tiles and layers (the codebook does not depend on the codes),
//   so the next layer's first tiles load during this layer's merge. One
//   copy a stage, not one cp.async a thread: those stalled every thread's
//   compute in the load unit (~560 cycles a stage on an H100);
// * warp w owns codes 16w..16w+15 of a tile (two n8 tiles) against all R
//   rows; per 8 dims it splits its A and B fragments, read from shared
//   memory without bank conflicts (a row stride of 4 mod 32 words; codes
//   through the swizzle), and issues 3 mma per (m16, n8) tile pair into two
//   accumulators (hi x hi, and the two cross terms); its lanes also sum
//   |e|^2 of their fragment's dims, the 4 lanes of a code group added by
//   shuffles;
// * each lane keeps a running (best distance, best code) for its 2 rows per
//   m16 tile, strict < over ascending codes; a group's 4 lanes meet by xor
//   shuffles, the 8 warps (in code order) through shared memory, lower code
//   first on equal distance.
// Across the cluster, per layer: each CTA writes its rows' (distance, code)
// to an exchange slot, cluster barrier, and every CTA merges the kCluster
// candidates of each row from the ranks' shared memory (distributed shared
// memory) in rank order, lower code first on equal distance; rank 0 writes
// the codes and every CTA subtracts the chosen global codebook rows from its
// own residual copy, each thread loading 8 float4s before it subtracts any
// (a load at a time waits out L2's latency each time: 4.6 us a layer on an
// H100). The slot alternates by
// layer parity, so a CTA never overwrites a slot a neighbour may still read
// (it cannot pass the next layer's barrier before every neighbour has
// arrived there, done reading); a last barrier keeps every CTA's shared
// memory alive until all have read.
// Ragged M and N are masked; a chunk past N (N < kCluster) walks one tile of
// zeros that no candidate comes from. A row none of whose distances is below
// +inf (a NaN in x) takes code 0, as an argmin over all-NaN distances does,
// so every code, and every gather, stays inside the codebook.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;         // CTAs per cluster: codebook chunks
constexpr int kMaxLayers = 16;      // residual layers one launch takes
constexpr int kMaxDim = 1024;       // the residual of 32 rows fits beside the ring
constexpr int kThreads = 256;       // 8 warps
constexpr int kTileCodes = 128;     // codes of a staged tile: 16 a warp
constexpr int kTilesN = 2;          // n8 tiles of a warp's 16 codes
constexpr int kDepth = 32;          // dims per stage: a code's 128-byte row
constexpr int kStages = 5;          // 4 stages (64 KB) in flight
constexpr int kStageWords = kTileCodes * kDepth;
constexpr int kStageBytes = 4 * kStageWords;
constexpr int kAlign = 1024;        // the 128-byte swizzle's period
constexpr int kBarWords = 8;        // 64 bits a stage's barrier, kept 16-byte aligned
static_assert(kStages <= kBarWords, "a barrier a stage");
constexpr int kMaxDevices = 64;

struct Books {
  const float* layer[kMaxLayers];
};

// one TMA descriptor a layer: the (N, D) codebook in boxes of kTileCodes
// codes x kDepth dims, 128-byte swizzled, zeros past N and D
struct Maps {
  CUtensorMap layer[kMaxLayers];
};

__device__ __forceinline__ bool better(float d2, int i2, float d1, int i1) {
  return d2 < d1 || (d2 == d1 && i2 < i1);
}

// f(0), f(1), ..., f(N - 1), each call inlined with its argument a constant
template <int N, typename F>
__device__ __forceinline__ void unrolled(F&& f) {
  if constexpr (N > 0) {
    unrolled<N - 1>(f);
    f(N - 1);
  }
}

// books.layer[l], read with constant indices only (a dynamic index would
// copy the parameter to local memory)
__device__ __forceinline__ const float* layer_book(const Books& books, int l) {
  const float* book = books.layer[0];
#pragma unroll
  for (int q = 1; q < kMaxLayers; ++q)
    if (q == l) book = books.layer[q];
  return book;
}

__host__ __device__ __forceinline__ int padded_dim(int d) {
  return (d + kDepth - 1) / kDepth * kDepth;
}

// words per residual row: conflict-free fragment reads
__host__ __device__ __forceinline__ int row_stride(int d) {
  return padded_dim(d) + 4;
}

size_t smem_bytes(int d, int rows) {
  return kAlign + sizeof(uint64_t) * kBarWords +
         sizeof(float) * (kStages * kStageWords +
                          static_cast<size_t>(rows) * row_stride(d) +
                          (2 + kThreads / 32) * rows) +
         sizeof(int) * (3 + kThreads / 32) * rows;
}

// word f of code c's 32 dims in a staged tile: its 16-byte piece f / 4
// swizzled by c % 8, as the TMA's 128-byte swizzle lays it down
__device__ __forceinline__ int staged(int c, int f) {
  return c * kDepth + ((f >> 2) ^ (c & 7)) * 4 + (f & 3);
}

// v = hi + lo: hi is v cut to tf32 (a 10-bit mantissa), lo = v - hi exactly
// in fp32, which the tensor cores read as tf32 (its top 19 bits), so hi + lo
// is v to about 2^-20 of v. Two full-rate instructions: a rounding
// conversion (cvt.rna.tf32.f32) compiles to five on sm_90a
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a b on the tensor cores: a 16 x 8 (rows x dims), b 8 x 8 (dims x
// codes), tf32 operands, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// one arrival that also expects `bytes` from the TMA
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the box at (dim x, code y) of `map` into dst, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// x (m, d); books.layer[l] (n, d); codes (m, nq) int32, row-major.
// Grid: kCluster CTAs per R-row tile, clusters of kCluster along x.
template <int R>
__global__ void __launch_bounds__(kThreads)
vq_search_kernel(const float* __restrict__ x, Books books,
                 const __grid_constant__ Maps maps, int* __restrict__ codes,
                 int m, int n, int d, int nq) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kTilesM = R / 16;  // m16 tiles of the rows
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  // [kStages][kTileCodes][kDepth], swizzled, kAlign-aligned
  float* ring = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) +
      ((kAlign - (smem_addr(smem4) & (kAlign - 1))) & (kAlign - 1)));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageWords);
  const int dp = padded_dim(d), xstride = row_stride(d);
  float* xs = reinterpret_cast<float*>(full + kBarWords);  // [R][xstride] residual
  float* xd = xs + R * xstride;                       // [2][R] exchange distances
  float* wd = xd + 2 * R;                             // [kWarps][R] warps' distances
  int* xi = reinterpret_cast<int*>(wd + kWarps * R);  // [2][R] exchange codes
  int* wi = xi + 2 * R;                               // [kWarps][R] warps' codes
  int* chosen = wi + kWarps * R;                      // [R]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.x / kCluster * R;
  const int chunk = (n + kCluster - 1) / kCluster;
  const int c0 = min(n, rank * chunk), c1 = min(n, c0 + chunk);
  const int tiles = (chunk + kTileCodes - 1) / kTileCodes;
  const int k_stages = dp / kDepth;
  const int total = nq * tiles * k_stages;

  // The copy side of the ring: thread 0 loads the next stage, (layer fl,
  // tile ft, dims kDepth * fk), into slot fslot with one TMA copy; the slot's
  // barrier completes when its bytes have landed.
  int fl = 0, ft = 0, fk = 0, fslot = 0, fs = 0;
  auto issue_next = [&]() {
    if (t == 0 && fs < total) {
      mbar_expect(full + fslot, kStageBytes);
      tma_load(ring + fslot * kStageWords, &maps.layer[fl], fk * kDepth,
               c0 + ft * kTileCodes, full + fslot);
    }
    if (++fk == k_stages) {
      fk = 0;
      if (++ft == tiles) {
        ft = 0;
        ++fl;
      }
    }
    fslot = fslot + 1 == kStages ? 0 : fslot + 1;
    ++fs;
  };
  if (t == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < kStages - 1; ++i) issue_next();

  for (int e = t; e < R * dp / 4; e += kThreads) {
    const int r = e / (dp / 4), k = 4 * (e % (dp / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < m && k < d)
      v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(row0 + r) * d + k);
    *reinterpret_cast<float4*>(xs + r * xstride + k) = v;
  }

  // Fragments (PTX mma.m16n8k8 .tf32): lane = 4 g + tig holds A at rows
  // g and g + 8, dims tig and tig + 4; B at code g, dims tig and tig + 4; C
  // at rows g and g + 8, codes 2 tig and 2 tig + 1. Warp w owns codes
  // 16 w..16 w + 15 of a tile, n8 tile nt its codes 8 nt..
  const int g = lane >> 2, tig = lane & 3;
  // acc sums hi hi, acc2 lo hi + hi lo: two chains of HMMA, not one
  float acc[kTilesM][kTilesN][4], acc2[kTilesM][kTilesN][4], sq[kTilesN];
  float best_d[kTilesM][2];
  int best_i[kTilesM][2];
#pragma unroll
  for (int mt = 0; mt < kTilesM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_d[mt][h] = INFINITY;
      best_i[mt][h] = INT_MAX;
    }
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = acc2[mt][nt][e] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kTilesN; ++nt) sq[nt] = 0.f;

  const float* xa = xs + g * xstride + tig;
  int l = 0, tile = 0, ks = 0, slot = 0;
  for (int s = 0; s < total; ++s) {
    mbar_wait(full + slot, (s / kStages) & 1);  // stage s has landed
    __syncthreads();  // every thread is done with stage s - 1
    issue_next();     // stage s + kStages - 1, into s - 1's slot

    const float* eb = ring + slot * kStageWords;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    const float* xk = xa + ks * kDepth;
    // 8 dims a step, the 4 steps of a stage unrolled by construction: each
    // product as 3xTF32, lo hi + hi lo + hi hi (lo lo dropped)
    unrolled<kDepth / 8>([&](const int step) {
      const int kk = 8 * step;
      uint32_t ah[kTilesM][4], al[kTilesM][4];
#pragma unroll
      for (int mt = 0; mt < kTilesM; ++mt) {
        const float* a = xk + 16 * mt * xstride + kk;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8 * xstride], ah[mt][1], al[mt][1]);
        split_tf32(a[4], ah[mt][2], al[mt][2]);
        split_tf32(a[8 * xstride + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kTilesN; ++nt) {
        const int c = 16 * warp + 8 * nt + g;
        const float e0 = eb[staged(c, kk + tig)];
        const float e1 = eb[staged(c, kk + 4 + tig)];
        sq[nt] = fmaf(e0, e0, sq[nt]);
        sq[nt] = fmaf(e1, e1, sq[nt]);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(e0, bh0, bl0);
        split_tf32(e1, bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < kTilesM; ++mt) {
          mma_tf32(acc2[mt][nt], al[mt], bh0, bh1);
          mma_tf32(acc2[mt][nt], ah[mt], bl0, bl1);
          mma_tf32(acc[mt][nt], ah[mt], bh0, bh1);
        }
      }
    });

    if (ks + 1 == k_stages) {
      // the tile's candidates
      const int base = c0 + tile * kTileCodes + 16 * warp + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kTilesN; ++nt) {
        // |e|^2 of code 8 nt + g: the partials of group g's 4 lanes; then
        // this lane's codes 8 nt + 2 tig (+ 1), groups 2 tig and 2 tig + 1
        float e2 = sq[nt];
        e2 += __shfl_xor_sync(0xffffffffu, e2, 1);
        e2 += __shfl_xor_sync(0xffffffffu, e2, 2);
        sq[nt] = 0.f;
        const float e2a = __shfl_sync(0xffffffffu, e2, 8 * tig);
        const float e2b = __shfl_sync(0xffffffffu, e2, 8 * tig + 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int code = base + 8 * nt + (e & 1);
#pragma unroll
          for (int mt = 0; mt < kTilesM; ++mt) {
            const float dist = ((e & 1) ? e2b : e2a) -
                               2.f * (acc2[mt][nt][e] + acc[mt][nt][e]);
            if (code < c1 && dist < best_d[mt][e >> 1]) {
              best_d[mt][e >> 1] = dist;
              best_i[mt][e >> 1] = code;
            }
            acc[mt][nt][e] = acc2[mt][nt][e] = 0.f;
          }
        }
      }
    }

    if (ks + 1 == k_stages && tile + 1 == tiles) {
      // the layer's end: each warp's candidate per row (a group's 4 lanes
      // share its rows), the CTA's (warps in code order), then the cluster's
      const int slot = (l & 1) * R;
#pragma unroll
      for (int mt = 0; mt < kTilesM; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float dd = best_d[mt][h];
          int ii = best_i[mt][h];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float d2 = __shfl_xor_sync(0xffffffffu, dd, off);
            const int i2 = __shfl_xor_sync(0xffffffffu, ii, off);
            if (better(d2, i2, dd, ii)) {
              dd = d2;
              ii = i2;
            }
          }
          if (tig == 0) {
            wd[warp * R + 16 * mt + 8 * h + g] = dd;
            wi[warp * R + 16 * mt + 8 * h + g] = ii;
          }
          best_d[mt][h] = INFINITY;
          best_i[mt][h] = INT_MAX;
        }
      __syncthreads();
      if (t < R) {
        float dd = wd[t];
        int ii = wi[t];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          if (better(wd[w * R + t], wi[w * R + t], dd, ii)) {
            dd = wd[w * R + t];
            ii = wi[w * R + t];
          }
        xd[slot + t] = dd;
        xi[slot + t] = ii;
      }
      cluster.sync();  // every rank's candidates are in its shared memory
      if (t < R) {
        float bd = INFINITY;
        int bi = INT_MAX;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) {
          const float d2 = cluster.map_shared_rank(xd + slot, q)[t];
          const int i2 = cluster.map_shared_rank(xi + slot, q)[t];
          if (better(d2, i2, bd, bi)) {
            bd = d2;
            bi = i2;
          }
        }
        if (bi == INT_MAX) bi = 0;  // every distance NaN: argmin's code
        chosen[t] = bi;
        if (rank == 0 && row0 + t < m)
          codes[static_cast<size_t>(row0 + t) * nq + l] = bi;
      }
      __syncthreads();
      if (l + 1 < nq) {
        // residual -= the chosen codebook row, exact fp32 (a gather): a
        // thread loads 8 float4s before it subtracts any
        const float* book = layer_book(books, l);
        const int q4 = d / 4, n4 = R * q4;
        for (int e0 = t; e0 < n4; e0 += 8 * kThreads) {
          float4 b[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads, r = e / q4;
            b[u] = e < n4 && row0 + r < m
                       ? __ldg(reinterpret_cast<const float4*>(
                             book + static_cast<size_t>(chosen[r]) * d +
                             4 * (e - r * q4)))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads, r = e / q4;
            if (e < n4) {
              float4* v = reinterpret_cast<float4*>(xs + r * xstride +
                                                    4 * (e - r * q4));
              v->x -= b[u].x;
              v->y -= b[u].y;
              v->z -= b[u].z;
              v->w -= b[u].w;
            }
          }
        }
      }
    }

    if (++ks == k_stages) {
      ks = 0;
      if (++tile == tiles) {
        tile = 0;
        ++l;
      }
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour reads its slots
}

// Opt the kernel in to its dynamic shared memory (above the 48 KB a block
// gets without asking) on the current device, once per device.
template <int R>
int opt_in() {
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev < kMaxDevices && opted[dev]) return 0;
  const cudaError_t set = cudaFuncSetAttribute(
      vq_search_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxDim, R)));
  if (set == cudaSuccess && dev < kMaxDevices) opted[dev] = true;
  return static_cast<int>(set);
}

void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int tiles,
               int d, int rows, void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(kCluster * tiles);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem_bytes(d, rows);
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no link to libcuda
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The TMA descriptor of the (n, d) codebook at `book`, encoded once and kept:
// a descriptor holds only the address and the shape.
constexpr int kMaxMaps = 256;

int tensor_map(const void* book, int n, int d, CUtensorMap* out) {
  struct Entry {
    const void* book;
    int n, d;
    CUtensorMap map;
  };
  static Entry cache[kMaxMaps];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].book == book && cache[i].n == n && cache[i].d == d) {
      *out = cache[i].map;
      return 0;
    }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(float)};
  const cuuint32_t box[2] = {kDepth, kTileCodes};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(book),
             dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (used == kMaxMaps) used = 0;
  cache[used++] = {book, n, d, *out};
  return 0;
}

template <int R>
int launch(const float* x, const Books& books, const Maps& maps, int* codes,
           int m, int n, int d, int nq, void* stream) {
  const int rc = opt_in<R>();
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, (m + R - 1) / R, d, R, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, vq_search_kernel<R>, x, books, maps, codes, m, n, d, nq);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int active_clusters(int d, int* out) {
  const int rc = opt_in<R>();
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  configure(&cfg, &attr, 1, d, R, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, vq_search_kernel<R>, &cfg));
}

bool valid_shape(int n, int d, int nq, int rows) {
  return (rows == 16 || rows == 32) && n > 0 && d > 0 && d % 16 == 0 &&
         d <= kMaxDim && nq > 0 && nq <= kMaxLayers;
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns a cudaError_t code,
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" {

// How many clusters of a launch of `rows` rows a cluster at width d the
// current device holds at once (cudaOccupancyMaxActiveClusters).
int vq_active_clusters(int d, int rows, int* out) {
  if (!valid_shape(1, d, 1, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  return rows == 16 ? active_clusters<16>(d, out) : active_clusters<32>(d, out);
}

// K5 (nq = 1) and K6: x (m, d); books, a host array of nq device pointers,
// each an (n, d) codebook; codes (m, nq); rows 16 or 32 a cluster.
int vq_search_f32(const void* x, const void* const* books, void* codes, int m,
                  int n, int d, int nq, int rows, void* stream) {
  if (m <= 0 || !valid_shape(n, d, nq, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  Books b = {};
  Maps maps = {};
  for (int l = 0; l < nq; ++l) {
    b.layer[l] = static_cast<const float*>(books[l]);
    const int rc = tensor_map(books[l], n, d, &maps.layer[l]);
    if (rc != 0) return rc;
  }
  const float* xp = static_cast<const float*>(x);
  int* out = static_cast<int*>(codes);
  return rows == 16 ? launch<16>(xp, b, maps, out, m, n, d, nq, stream)
                    : launch<32>(xp, b, maps, out, m, n, d, nq, stream);
}

}  // extern "C"
