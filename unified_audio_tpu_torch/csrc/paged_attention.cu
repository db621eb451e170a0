// Owner-mode paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels in unified_audio_tpu/ops/pallas/paged_attention.py:
//   K1  paged_flash_decode_owner     (_owner_kernel_flat):    bf16 / fp32 pool
//   K2  paged_flash_decode_owner_q8  (_owner_kernel_flat_q8): int8 pool with
//       fp32 per-token scales
//
// What it computes. One decode query per slot s and head h attends to the
// slot's own keys at slot-local positions p <= index[s]. Position p lives in
// physical block start_block[s] + p / BS at offset p % BS of the flat pool
// (L, NB, BS, H*HD), columns [h*HD, (h+1)*HD). Softmax runs in fp32; an
// inactive slot (index < 0) returns zeros. For the int8 pool the layer's
// per-token scales fold in by row exactly as the TPU kernel and the plain
// path do: logits = (q . k_int8) * (k_scale * 1/sqrt(HD)), and the
// probabilities are multiplied by v_scale before the p.v product.
//
// What bounds it on this card. Each call reads the owned KV prefix of every
// slot once: 2 * sum_s (index[s] + 1) * HD * bytes per element for each head,
// about 17.6 MB per layer for 16 slots at 536 cached tokens in bf16 (half
// that for int8). At 3.35 TB/s that is ~5 us per layer, so the kernel is
// memory-bound and its time is set by how many bytes are in flight. The
// arithmetic (two dot products of HD per key) is negligible.
//
// Design. One thread block per (slot, head), 128 threads. Thread t takes
// positions t, t+128, t+256, ... and keeps its own online-softmax state
// (running max, denominator, HD accumulators) in registers, so the key loop
// has no cross-thread reduction. Each thread reads whole K and V rows with
// 16-byte (8-element) loads, all issued before they are used. At the end the
// 128 partial states merge through shared memory. The TPU kernel's 128-lane
// chunk rule, its block-diagonal head picker and its clamped chunk re-reads
// were Mosaic constraints and have no counterpart here: the loop simply
// stops at index[s]. Split-K over chunks, cp.async/TMA staging and several
// slots per block are the levers for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;   // head dim the kernels are built for (UniSE LM)
constexpr int kThreads = 128;  // 4 warps per (slot, head) block

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// QT: query/output type; KT: pool element type; kQ8: int8 pool with scales.
template <typename QT, typename KT, bool kQ8>
__global__ void __launch_bounds__(kThreads)
owner_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kpool,
                    const KT* __restrict__ vpool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ start_block,
                    const int* __restrict__ index, QT* __restrict__ out,
                    int num_heads, int num_blocks, int block_size, int layer,
                    float scale) {
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int idx = index[s];
  const long long start = start_block[s];
  const long long row = static_cast<long long>(num_heads) * kHeadDim;
  // the layer's pool slice, offset to this head's columns
  const long long layer_off =
      static_cast<long long>(layer) * num_blocks * block_size * row +
      static_cast<long long>(h) * kHeadDim;
  const KT* kbase = kpool + layer_off;
  const KT* vbase = vpool + layer_off;

  // the query row lives in shared memory (read as a broadcast), which keeps
  // the registers for the K/V rows and the accumulators
  __shared__ float qs[kHeadDim];
  const QT* qrow = q + (static_cast<long long>(s) * num_heads + h) * kHeadDim;
  if (t < kHeadDim / 8) load8(qrow + 8 * t, qs + 8 * t);
  __syncthreads();

  float m = -INFINITY;
  float l = 0.f;
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;

  for (int p = t; p <= idx; p += kThreads) {
    // token slot of position p inside the layer: block * BS + offset
    const long long tok = (start + p / block_size) * block_size + p % block_size;
    const KT* krow = kbase + tok * row;
    const KT* vrow = vbase + tok * row;
    float kf[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 8) load8(krow + d, kf + d);
    float vf[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 8) load8(vrow + d, vf + d);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qs[d], kf[d], dot);
    const float logit = kQ8 ? dot * (k_scale[tok] * scale) : dot * scale;
    const float m_new = fmaxf(m, logit);
    const float alpha = expf(m - m_new);  // 0 on the first key (m = -inf)
    const float prob = expf(logit - m_new);
    l = l * alpha + prob;
    const float pv = kQ8 ? prob * v_scale[tok] : prob;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(acc[d], alpha, pv * vf[d]);
    m = m_new;
  }

  // merge the 128 partial softmax states: global max, rescale, sum
  __shared__ float warp_max[kThreads / 32];
  __shared__ float warp_den[kThreads / 32];
  __shared__ float partial[kThreads][kHeadDim + 1];  // +1: no bank conflicts

  float wm = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
  if (lane == 0) warp_max[warp] = wm;
  __syncthreads();
  float big = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) big = fmaxf(big, warp_max[w]);

  QT* orow = out + (static_cast<long long>(s) * num_heads + h) * kHeadDim;
  if (big == -INFINITY) {  // no visible key: an inactive slot
    if (t < kHeadDim) store(orow + t, 0.f);
    return;
  }
  const float f = (m == -INFINITY) ? 0.f : expf(m - big);
  float den = l * f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
  if (lane == 0) warp_den[warp] = den;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) partial[t][d] = acc[d] * f;
  __syncthreads();
  if (t < kHeadDim) {
    float total = 0.f;
    for (int r = 0; r < kThreads; ++r) total += partial[r][t];
    float denom = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) denom += warp_den[w];
    store(orow + t, total * (1.f / denom));
  }
}

template <typename QT, typename KT, bool kQ8>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* k_scale, const void* v_scale, const void* start_block,
           const void* index, void* out, int num_slots, int num_heads,
           int num_blocks, int block_size, int layer, float scale,
           void* stream) {
  const dim3 grid(num_slots * num_heads);
  owner_decode_kernel<QT, KT, kQ8><<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kpool),
      static_cast<const KT*>(vpool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(start_block),
      static_cast<const int*>(index), static_cast<QT*>(out), num_heads,
      num_blocks, block_size, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError().
extern "C" {

int owner_decode_f32(const void* q, const void* kpool, const void* vpool,
                     const void* start_block, const void* index, void* out,
                     int num_slots, int num_heads, int num_blocks,
                     int block_size, int layer, float scale, void* stream) {
  return launch<float, float, false>(q, kpool, vpool, nullptr, nullptr,
                                     start_block, index, out, num_slots,
                                     num_heads, num_blocks, block_size, layer,
                                     scale, stream);
}

int owner_decode_bf16(const void* q, const void* kpool, const void* vpool,
                      const void* start_block, const void* index, void* out,
                      int num_slots, int num_heads, int num_blocks,
                      int block_size, int layer, float scale, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, kpool, vpool, nullptr, nullptr, start_block, index, out, num_slots,
      num_heads, num_blocks, block_size, layer, scale, stream);
}

int owner_decode_q8_f32(const void* q, const void* kpool, const void* vpool,
                        const void* k_scale, const void* v_scale,
                        const void* start_block, const void* index, void* out,
                        int num_slots, int num_heads, int num_blocks,
                        int block_size, int layer, float scale, void* stream) {
  return launch<float, int8_t, true>(q, kpool, vpool, k_scale, v_scale,
                                     start_block, index, out, num_slots,
                                     num_heads, num_blocks, block_size, layer,
                                     scale, stream);
}

int owner_decode_q8_bf16(const void* q, const void* kpool, const void* vpool,
                         const void* k_scale, const void* v_scale,
                         const void* start_block, const void* index, void* out,
                         int num_slots, int num_heads, int num_blocks,
                         int block_size, int layer, float scale, void* stream) {
  return launch<__nv_bfloat16, int8_t, true>(
      q, kpool, vpool, k_scale, v_scale, start_block, index, out, num_slots,
      num_heads, num_blocks, block_size, layer, scale, stream);
}

}  // extern "C"
