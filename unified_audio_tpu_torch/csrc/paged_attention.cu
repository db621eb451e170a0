// Paged flash-decode attention for Hopper (sm_90a): the owner, the stream
// and the block-table kernels.
//
// Replaces the TPU kernels in unified_audio_tpu/ops/pallas/paged_attention.py:
//   K1  paged_flash_decode_owner     (_owner_kernel_flat):    bf16 / fp32 pool
//   K2  paged_flash_decode_owner_q8  (_owner_kernel_flat_q8): int8 pool with
//       fp32 per-token scales
//   K3  paged_flash_decode_stream_flat     (_stream_kernel_flat): bf16 / fp32
//   K4  paged_flash_decode_stream_flat_q8  (_stream_kernel_flat_q8): int8
//   K7  paged_flash_decode  (_kernel, the block-table decode): bf16 / fp32
//
// What they compute. One decode query per slot s and head h attends to keys
// of the flat pool (L, NB, BS, H*HD), columns [h*HD, (h+1)*HD), softmax in
// fp32, output in q's dtype. Which keys:
//   owner (K1/K2): the slot's own positions p <= index[s]; position p lives
//     in physical block start_block[s] + p / BS at offset p % BS. An
//     inactive slot (index < 0) returns zeros.
//   stream (K3/K4): every key of the pool prefix [0, bound * BS) whose byte
//     in the slot's row of the (S, bound * BS) int8 visibility mask is
//     non-zero. A row with no visible key returns zeros.
//   table (K7): the slot's logical positions p <= index[s] with p < MB * BS;
//     position p lives in physical block tables[s, p / BS] at offset p % BS.
//     Positions, not blocks: a table repeating a block attends its rows once
//     per position; entries past the last position are never read. An
//     inactive slot (index < 0) returns zeros.
// For the int8 pool the layer's per-token scales fold in by row exactly as
// the TPU kernels and the plain paths do: logits = (q . k_int8) *
// (k_scale * 1/sqrt(HD)) before the mask, and the probabilities are
// multiplied by v_scale before the p.v product while the denominator sums
// the unscaled probabilities.
//
// What bounds them on this card. Each call reads the K and V rows its slots
// may see once: 2 * HD * bytes per element for each visible key and head,
// about 17.6 MB per layer for 16 slots at 536 cached tokens in bf16 (half
// that for int8). At 3.35 TB/s that is ~5 us per layer, so the kernels are
// memory-bound and their time is set by how many bytes are in flight. The
// arithmetic (two dot products of HD per visible key) is negligible. The
// stream kernels also read the visibility mask (S * bound * BS bytes, 20 KB
// per slot at a 320-block bound), once per head; the table kernel reads a
// slot's table entries (4 bytes a block) once per head.
//
// Two designs live here, both one thread block per (slot, head) in which
// thread t keeps its own online-softmax state (running max, denominator,
// HD accumulators) in registers for keys t, t + T, ..., so the key loop has
// no cross-thread reduction, and the T states merge at the end.
//
// The pipelined design (K2, K3; redesigned for Hopper). T = 256 threads (8
// warps; 128 blocks at 16 slots fill the SMs one block each, with half the
// keys per thread of 128 threads). A thread holds a key as its raw
// 16-byte words (the K and V rows of its head, the int8 scales, the mask
// byte) and issues the next key's loads before it computes this one: two
// keys in flight per thread (254-255 registers, no spills; fp32 rows, 128
// registers a key, go one at a time). The dot product runs in four
// independent sums, int8 values become floats by a byte permute into 2^23's
// mantissa (exact, two full-rate instructions instead of the quarter-rate
// conversion), and K3 loads a key's mask byte beside its rows instead of
// before them. The merge is a reduce-scatter of shuffles in each warp (lane
// L ends with columns 2L, 2L + 1) and one shared-memory row per warp,
// instead of 128 rows summed in series. On an H100 both kernels are faster
// than the 128-thread design, alone and inside the decode step (PERF.md;
// K2 by a third, K3 by a tenth). A split-K version (a thread-block cluster
// of blocks per slot, all heads per block, K/V tiles by cp.async.bulk, the
// merge in distributed shared memory) beat the old kernels alone but lost
// to them inside the decode step, where its blocks started microseconds
// apart, and was not kept.
//
// The per-(slot, head) design of the first port (K1, K4, K7). T = 128
// threads; each thread reads whole K and V rows with 16-byte (8-element)
// loads, all issued before they are used, one key at a time; at the end the
// 128 partial states merge through shared memory (64 threads each adding
// 128 rows). The owner kernel walks positions t, t+128, ... up to index[s].
// The table kernel walks positions the same way (one code path, templated
// on the map from a position to its row); it first stages the table
// entries its positions reach in shared memory, so each position costs one
// shared-memory read before its K/V rows. The TPU kernel runs one grid step
// per (slot, logical block), all heads at once, and carries the softmax
// state between steps in scratch; here the block loop is inside the thread
// block and the heads are split over blocks.
// The TPU stream kernel walks the prefix in chunks with all slots at once
// (one program, one core); a slot owns a few percent of a serving prefix,
// so here each (slot, head) block of K3 and K4 first finds, T physical
// blocks at a time, the blocks holding any visible key for its slot
// (16-byte mask loads, a warp ballot and a block-wide compaction into
// shared memory), then spreads those blocks' keys over its threads and
// skips the masked ones. Fully masked blocks cost one mask read and no K/V
// traffic, and no masked key enters the softmax state, so the running max
// starts at -inf without the exp(-inf - -inf) hazard. The Mosaic chunk
// rules (chunk * BS a multiple of 128, the bound divisible by the chunk)
// have no counterpart: the bound is any block count up to the pool's.
// Tensor cores are not used: with one query row per (slot, head), QK^T and
// p.v are matrix-vector products at about one operation per byte read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;   // head dim the kernels are built for (UniSE LM)
constexpr int kThreads = 128;  // 4 warps per (slot, head) block
constexpr int kWarps = kThreads / 32;

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

// The query row of (slot, head) into shared memory (read as a broadcast),
// which keeps the registers for the K/V rows and the accumulators.
template <typename QT>
__device__ __forceinline__ void load_query(const QT* q, int s, int h,
                                           int num_heads, float* qs) {
  const QT* qrow = q + (static_cast<long long>(s) * num_heads + h) * kHeadDim;
  if (threadIdx.x < kHeadDim / 8) load8(qrow + 8 * threadIdx.x, qs + 8 * threadIdx.x);
  __syncthreads();
}

// One key of the online softmax: m the running max (-inf before the first
// key), l the denominator, acc the p-weighted V sum. k_sc/v_sc are the int8
// pool's per-token scales (ignored for a float pool).
template <typename KT, bool kQ8>
__device__ __forceinline__ void attend_key(const float* qs, const KT* krow,
                                           const KT* vrow, float k_sc,
                                           float v_sc, float scale, float& m,
                                           float& l, float* acc) {
  float kf[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 8) load8(krow + d, kf + d);
  float vf[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 8) load8(vrow + d, vf + d);
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qs[d], kf[d], dot);
  const float logit = kQ8 ? dot * (k_sc * scale) : dot * scale;
  const float m_new = fmaxf(m, logit);
  const float alpha = expf(m - m_new);  // 0 on the first key (m = -inf)
  const float prob = expf(logit - m_new);
  l = l * alpha + prob;
  const float pv = kQ8 ? prob * v_sc : prob;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(acc[d], alpha, pv * vf[d]);
  m = m_new;
}

// Merge the 128 threads' softmax states (global max, rescale, sum) and write
// the (slot, head) output row; zeros where no thread saw a key.
template <typename QT>
__device__ __forceinline__ void merge_store(float m, float l, const float* acc,
                                            QT* orow) {
  __shared__ float warp_max[kWarps];
  __shared__ float warp_den[kWarps];
  __shared__ float partial[kThreads][kHeadDim + 1];  // +1: no bank conflicts
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  float wm = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
  if (lane == 0) warp_max[warp] = wm;
  __syncthreads();
  float big = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) big = fmaxf(big, warp_max[w]);

  if (big == -INFINITY) {  // no visible key: an inactive or empty row
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
    for (int w = 0; w < kWarps; ++w) denom += warp_den[w];
    store(orow + t, total * (1.f / denom));
  }
}

// Token row inside the layer (block * BS + offset) of a slot's position p.
// K1: the slot's contiguous region, from its first block.
struct RegionRows {
  long long start;
  int block_size;
  __device__ __forceinline__ long long operator()(int p) const {
    return (start + p / block_size) * block_size + p % block_size;
  }
};

// K7: the slot's block table, staged in shared memory.
struct TableRows {
  const int* table;
  int block_size;
  __device__ __forceinline__ long long operator()(int p) const {
    return static_cast<long long>(table[p / block_size]) * block_size +
           p % block_size;
  }
};

// The flash decode of one (slot, head) over positions 0..last, thread t
// taking positions t, t+128, ...; `rows` maps a position to its token row.
// QT: the query, output and pool element type (bf16 or fp32).
template <typename QT, typename Rows>
__device__ __forceinline__ void decode_positions(
    const QT* __restrict__ q, const QT* __restrict__ kpool,
    const QT* __restrict__ vpool, Rows rows, int last, QT* __restrict__ out,
    int s, int h, int num_heads, int num_blocks, int block_size, int layer,
    float scale) {
  const long long row = static_cast<long long>(num_heads) * kHeadDim;
  // the layer's pool slice, offset to this head's columns
  const long long layer_off =
      static_cast<long long>(layer) * num_blocks * block_size * row +
      static_cast<long long>(h) * kHeadDim;
  const QT* kbase = kpool + layer_off;
  const QT* vbase = vpool + layer_off;

  __shared__ float qs[kHeadDim];
  load_query(q, s, h, num_heads, qs);

  float m = -INFINITY;
  float l = 0.f;
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;

  for (int p = threadIdx.x; p <= last; p += kThreads) {
    const long long tok = rows(p);
    attend_key<QT, false>(qs, kbase + tok * row, vbase + tok * row, 1.f, 1.f,
                          scale, m, l, acc);
  }
  merge_store(m, l, acc,
              out + (static_cast<long long>(s) * num_heads + h) * kHeadDim);
}

template <typename QT>
__global__ void __launch_bounds__(kThreads)
owner_decode_kernel(const QT* __restrict__ q, const QT* __restrict__ kpool,
                    const QT* __restrict__ vpool,
                    const int* __restrict__ start_block,
                    const int* __restrict__ index, QT* __restrict__ out,
                    int num_heads, int num_blocks, int block_size, int layer,
                    float scale) {
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  decode_positions(q, kpool, vpool, RegionRows{start_block[s], block_size},
                   index[s], out, s, h, num_heads, num_blocks, block_size,
                   layer, scale);
}

// One block per (slot, head). Dynamic shared memory: max_blocks ints.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
table_decode_kernel(const QT* __restrict__ q, const QT* __restrict__ kpool,
                    const QT* __restrict__ vpool,
                    const int* __restrict__ tables,
                    const int* __restrict__ index, QT* __restrict__ out,
                    int num_heads, int num_blocks, int block_size,
                    int max_blocks, int layer, float scale) {
  extern __shared__ int table[];
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  // the TPU grid covers the table's blocks only: positions past it are not
  // attended, whatever the index
  const int last = static_cast<int>(
      min(static_cast<long long>(index[s]),
          static_cast<long long>(max_blocks) * block_size - 1));
  const int n_entries = last < 0 ? 0 : last / block_size + 1;
  const int* slot_table = tables + static_cast<long long>(s) * max_blocks;
  for (int i = threadIdx.x; i < n_entries; i += kThreads) {
    table[i] = slot_table[i];
  }
  __syncthreads();
  decode_positions(q, kpool, vpool, TableRows{table, block_size}, last, out,
                   s, h, num_heads, num_blocks, block_size, layer, scale);
}

// K4: the stream flash decode over an int8 pool with per-token scales.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
stream_decode_kernel(const QT* __restrict__ q,
                     const int8_t* __restrict__ kpool,
                     const int8_t* __restrict__ vpool,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int8_t* __restrict__ vis, QT* __restrict__ out,
                     int num_heads, int num_blocks, int block_size, int bound,
                     int layer, float scale) {
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long row = static_cast<long long>(num_heads) * kHeadDim;
  const long long layer_off =
      static_cast<long long>(layer) * num_blocks * block_size * row +
      static_cast<long long>(h) * kHeadDim;
  const int8_t* kbase = kpool + layer_off;
  const int8_t* vbase = vpool + layer_off;
  // the slot's row of the mask: one byte per key of the prefix
  const int8_t* seen = vis + static_cast<long long>(s) * bound * block_size;

  __shared__ float qs[kHeadDim];
  load_query(q, s, h, num_heads, qs);
  __shared__ int live[kThreads];      // this round's blocks with a visible key
  __shared__ int warp_live[kWarps];

  float m = -INFINITY;
  float l = 0.f;
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;

  for (int base = 0; base < bound; base += kThreads) {
    // thread t checks physical block base + t: any visible key in its
    // block_size mask bytes (16 at a time)
    const int b = base + t;
    bool any = false;
    if (b < bound) {
      const uint4* words = reinterpret_cast<const uint4*>(
          seen + static_cast<long long>(b) * block_size);
      for (int i = 0; i < block_size / 16; ++i) {
        const uint4 w = words[i];
        any |= (w.x | w.y | w.z | w.w) != 0u;
      }
    }
    // compact the live blocks into live[0, n_live), in block order
    const unsigned ballot = __ballot_sync(0xffffffffu, any);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int n_live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      offset += (w < warp) ? warp_live[w] : 0;
      n_live += warp_live[w];
    }
    if (any) live[offset + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();
    // the live blocks' keys, spread over the threads; masked keys skipped
    for (int i = t; i < n_live * block_size; i += kThreads) {
      const long long tok =
          static_cast<long long>(live[i / block_size]) * block_size +
          i % block_size;
      if (seen[tok] == 0) continue;
      attend_key<int8_t, true>(qs, kbase + tok * row, vbase + tok * row,
                               k_scale[tok], v_scale[tok], scale, m, l, acc);
    }
    __syncthreads();  // live[] and warp_live[] are rewritten next round
  }
  merge_store(m, l, acc,
              out + (static_cast<long long>(s) * num_heads + h) * kHeadDim);
}

// ---------------------------------------------------------------------------
// The pipelined per-(slot, head) design (K2, K3): see the header.
// ---------------------------------------------------------------------------

constexpr int kPipeThreads = 256;  // 8 warps per (slot, head) block
constexpr int kPipeWarps = kPipeThreads / 32;

// One head's K or V row (HD elements) as loaded: 16-byte words.
template <typename KT>
struct RawRow {
  static constexpr int kWords = kHeadDim * static_cast<int>(sizeof(KT)) / 16;
  static constexpr int kPerWord = 16 / static_cast<int>(sizeof(KT));
  uint4 w[kWords];
};

// Four int8 values (one 32-bit word) as exact floats without the
// quarter-rate integer conversion: each byte, offset to unsigned, becomes
// the low mantissa byte of 2^23 (one byte permute), less 2^23 + 128.
__device__ __forceinline__ void i8x4_to_float(uint32_t word, float* out) {
  const uint32_t biased = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + i)) -
             8388736.f;
  }
}

// The elements of one 16-byte word as floats.
__device__ __forceinline__ void word_to_float(const uint4& w, float* out,
                                              const float*) {
  out[0] = __uint_as_float(w.x); out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z); out[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void word_to_float(const uint4& w, float* out,
                                              const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void word_to_float(const uint4& w, float* out,
                                              const int8_t*) {
  i8x4_to_float(w.x, out);
  i8x4_to_float(w.y, out + 4);
  i8x4_to_float(w.z, out + 8);
  i8x4_to_float(w.w, out + 12);
}

// A key as one thread holds it between its load and its use: the raw K and
// V rows of the head, the int8 scales, the mask byte.
template <typename KT>
struct PipeKey {
  RawRow<KT> k, v;
  float k_sc, v_sc;
  int8_t seen;
};

template <typename KT, bool kQ8, bool kMask>
__device__ __forceinline__ void fetch_key(const KT* kbase, const KT* vbase,
                                          long long row, const float* k_scale,
                                          const float* v_scale,
                                          const int8_t* seen, long long tok,
                                          PipeKey<KT>& key) {
  const uint4* kw = reinterpret_cast<const uint4*>(kbase + tok * row);
  const uint4* vw = reinterpret_cast<const uint4*>(vbase + tok * row);
#pragma unroll
  for (int i = 0; i < RawRow<KT>::kWords; ++i) key.k.w[i] = __ldg(kw + i);
#pragma unroll
  for (int i = 0; i < RawRow<KT>::kWords; ++i) key.v.w[i] = __ldg(vw + i);
  key.k_sc = kQ8 ? __ldg(k_scale + tok) : 1.f;
  key.v_sc = kQ8 ? __ldg(v_scale + tok) : 1.f;
  key.seen = kMask ? seen[tok] : 1;
}

// One key of the online softmax (as attend_key), from its raw rows; the dot
// product in four independent sums. A masked key leaves the state as it is.
template <typename KT, bool kQ8, bool kMask>
__device__ __forceinline__ void attend_raw(const float* qs,
                                           const PipeKey<KT>& key, float scale,
                                           float& m, float& l, float* acc) {
  if (kMask && key.seen == 0) return;
  constexpr int kPer = RawRow<KT>::kPerWord;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < RawRow<KT>::kWords; ++i) {
    float kf[kPer];
    word_to_float(key.k.w[i], kf, static_cast<const KT*>(nullptr));
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      part[e & 3] = fmaf(qs[i * kPer + e], kf[e], part[e & 3]);
    }
  }
  const float dot = (part[0] + part[1]) + (part[2] + part[3]);
  const float logit = kQ8 ? dot * (key.k_sc * scale) : dot * scale;
  const float m_new = fmaxf(m, logit);
  const float alpha = expf(m - m_new);  // 0 on the first key (m = -inf)
  const float prob = expf(logit - m_new);
  l = l * alpha + prob;
  const float pv = kQ8 ? prob * key.v_sc : prob;
#pragma unroll
  for (int i = 0; i < RawRow<KT>::kWords; ++i) {
    float vf[kPer];
    word_to_float(key.v.w[i], vf, static_cast<const KT*>(nullptr));
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      acc[i * kPer + e] = fmaf(acc[i * kPer + e], alpha, pv * vf[e]);
    }
  }
  m = m_new;
}

// Keys j = t, t + 256, ... below n (token row tok_of(j) in the layer), into
// this thread's softmax state. For 1- and 2-byte pools the next key's loads
// are issued before this key is computed (two keys in flight a thread);
// fp32 rows (128 registers a key) are loaded one key at a time.
template <typename KT, bool kQ8, bool kMask, typename TokOf>
__device__ __forceinline__ void walk_keys(int n, TokOf tok_of,
                                          const float* qs, const KT* kbase,
                                          const KT* vbase, long long row,
                                          const float* k_scale,
                                          const float* v_scale,
                                          const int8_t* seen, float scale,
                                          float& m, float& l, float* acc) {
  PipeKey<KT> a;
  int j = threadIdx.x;
  if constexpr (sizeof(KT) < 4) {
    PipeKey<KT> b;
    if (j < n) {
      fetch_key<KT, kQ8, kMask>(kbase, vbase, row, k_scale, v_scale, seen,
                                tok_of(j), a);
    }
    for (; j < n; j += 2 * kPipeThreads) {
      if (j + kPipeThreads < n) {
        fetch_key<KT, kQ8, kMask>(kbase, vbase, row, k_scale, v_scale, seen,
                                  tok_of(j + kPipeThreads), b);
      }
      attend_raw<KT, kQ8, kMask>(qs, a, scale, m, l, acc);
      if (j + kPipeThreads >= n) break;
      if (j + 2 * kPipeThreads < n) {
        fetch_key<KT, kQ8, kMask>(kbase, vbase, row, k_scale, v_scale, seen,
                                  tok_of(j + 2 * kPipeThreads), a);
      }
      attend_raw<KT, kQ8, kMask>(qs, b, scale, m, l, acc);
    }
  } else {
    for (; j < n; j += kPipeThreads) {
      fetch_key<KT, kQ8, kMask>(kbase, vbase, row, k_scale, v_scale, seen,
                                tok_of(j), a);
      attend_raw<KT, kQ8, kMask>(qs, a, scale, m, l, acc);
    }
  }
}

// One halving of a warp's reduce-scatter of acc: lanes with bit kHalf / 2
// set keep the upper kHalf values and take their partner's, the others the
// lower ones; acc[0, kHalf) then holds the pair's sums.
template <int kHalf>
__device__ __forceinline__ void fold_half(float* acc, int lane) {
  const bool upper = (lane & (kHalf / 2)) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float keep = upper ? acc[j + kHalf] : acc[j];
    const float send = upper ? acc[j] : acc[j + kHalf];
    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf / 2);
  }
}

// Merge the 256 threads' softmax states and write the (slot, head) output
// row; zeros where no thread saw a key. Each warp sums its lanes' rescaled
// accumulators by a reduce-scatter of shuffles (lane L ends with columns 2L
// and 2L + 1), then 64 threads add the 8 warps' rows.
template <typename QT>
__device__ __forceinline__ void merge_store_pipe(float m, float l, float* acc,
                                                 QT* orow) {
  __shared__ float warp_max[kPipeWarps];
  __shared__ float warp_den[kPipeWarps];
  __shared__ float warp_acc[kPipeWarps][kHeadDim];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  float wm = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
  if (lane == 0) warp_max[warp] = wm;
  __syncthreads();
  float big = warp_max[0];
#pragma unroll
  for (int w = 1; w < kPipeWarps; ++w) big = fmaxf(big, warp_max[w]);

  if (big == -INFINITY) {  // no visible key: an inactive or empty row
    if (t < kHeadDim) store(orow + t, 0.f);
    return;
  }
  const float f = (m == -INFINITY) ? 0.f : expf(m - big);
  float den = l * f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
  if (lane == 0) warp_den[warp] = den;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] *= f;
  fold_half<32>(acc, lane);
  fold_half<16>(acc, lane);
  fold_half<8>(acc, lane);
  fold_half<4>(acc, lane);
  fold_half<2>(acc, lane);
  warp_acc[warp][2 * lane] = acc[0];
  warp_acc[warp][2 * lane + 1] = acc[1];
  __syncthreads();
  if (t < kHeadDim) {
    float total = 0.f;
    float denom = 0.f;
#pragma unroll
    for (int w = 0; w < kPipeWarps; ++w) {
      total += warp_acc[w][t];
      denom += warp_den[w];
    }
    store(orow + t, total * (1.f / denom));
  }
}

// K2: the owner flash decode over an int8 pool; thread t takes positions
// t, t + 256, ... <= index[s], rows start_block[s] * BS + p of the layer.
template <typename QT>
__global__ void __launch_bounds__(kPipeThreads, 1)
owner_decode_kernel_pipelined(const QT* __restrict__ q,
                              const int8_t* __restrict__ kpool,
                              const int8_t* __restrict__ vpool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ start_block,
                              const int* __restrict__ index,
                              QT* __restrict__ out, int num_heads,
                              int num_blocks, int block_size, int layer,
                              float scale) {
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const long long row = static_cast<long long>(num_heads) * kHeadDim;
  const long long layer_off =
      static_cast<long long>(layer) * num_blocks * block_size * row +
      static_cast<long long>(h) * kHeadDim;
  const long long first = static_cast<long long>(start_block[s]) * block_size;
  const int n = max(index[s] + 1, 0);

  __shared__ float qs[kHeadDim];
  load_query(q, s, h, num_heads, qs);
  float m = -INFINITY;
  float l = 0.f;
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  walk_keys<int8_t, true, false>(
      n, [&](int p) { return first + p; }, qs, kpool + layer_off,
      vpool + layer_off, row, k_scale, v_scale, nullptr, scale, m, l, acc);
  merge_store_pipe(m, l, acc,
                   out + (static_cast<long long>(s) * num_heads + h) * kHeadDim);
}

// K3: the stream flash decode over a bf16 or fp32 pool. Each round finds
// 256 physical blocks' live ones for the slot (as stream_decode_kernel),
// then spreads their keys over the threads; a key's mask byte is loaded
// with its rows, and a masked key is skipped when it is used.
template <typename QT>
__global__ void __launch_bounds__(kPipeThreads, 1)
stream_decode_kernel_pipelined(const QT* __restrict__ q,
                               const QT* __restrict__ kpool,
                               const QT* __restrict__ vpool,
                               const int8_t* __restrict__ vis,
                               QT* __restrict__ out, int num_heads,
                               int num_blocks, int block_size, int bound,
                               int layer, float scale) {
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long row = static_cast<long long>(num_heads) * kHeadDim;
  const long long layer_off =
      static_cast<long long>(layer) * num_blocks * block_size * row +
      static_cast<long long>(h) * kHeadDim;
  const int8_t* seen = vis + static_cast<long long>(s) * bound * block_size;

  __shared__ float qs[kHeadDim];
  load_query(q, s, h, num_heads, qs);
  __shared__ int live[kPipeThreads];
  __shared__ int warp_live[kPipeWarps];

  float m = -INFINITY;
  float l = 0.f;
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;

  for (int base = 0; base < bound; base += kPipeThreads) {
    const int b = base + t;
    bool any = false;
    if (b < bound) {
      const uint4* words = reinterpret_cast<const uint4*>(
          seen + static_cast<long long>(b) * block_size);
      for (int i = 0; i < block_size / 16; ++i) {
        const uint4 w = words[i];
        any |= (w.x | w.y | w.z | w.w) != 0u;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, any);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int n_live = 0;
#pragma unroll
    for (int w = 0; w < kPipeWarps; ++w) {
      offset += (w < warp) ? warp_live[w] : 0;
      n_live += warp_live[w];
    }
    if (any) live[offset + __popc(ballot & ((1u << lane) - 1u))] = b;
    __syncthreads();
    walk_keys<QT, false, true>(
        n_live * block_size,
        [&](int i) {
          return static_cast<long long>(live[i / block_size]) * block_size +
                 i % block_size;
        },
        qs, kpool + layer_off, vpool + layer_off, row, nullptr, nullptr,
        seen, scale, m, l, acc);
    __syncthreads();  // live[] and warp_live[] are rewritten next round
  }
  merge_store_pipe(m, l, acc,
                   out + (static_cast<long long>(s) * num_heads + h) * kHeadDim);
}

template <typename QT>
int launch_owner_pipelined(const void* q, const void* kpool,
                           const void* vpool, const void* k_scale,
                           const void* v_scale, const void* start_block,
                           const void* index, void* out, int num_slots,
                           int num_heads, int num_blocks, int block_size,
                           int layer, float scale, void* stream) {
  owner_decode_kernel_pipelined<QT><<<num_slots * num_heads, kPipeThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const int8_t*>(kpool),
      static_cast<const int8_t*>(vpool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(start_block),
      static_cast<const int*>(index), static_cast<QT*>(out), num_heads,
      num_blocks, block_size, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_stream_pipelined(const void* q, const void* kpool,
                            const void* vpool, const void* vis, void* out,
                            int num_slots, int num_heads, int num_blocks,
                            int block_size, int bound, int layer, float scale,
                            void* stream) {
  stream_decode_kernel_pipelined<QT><<<num_slots * num_heads, kPipeThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(kpool),
      static_cast<const QT*>(vpool), static_cast<const int8_t*>(vis),
      static_cast<QT*>(out), num_heads, num_blocks, block_size, bound, layer,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_owner(const void* q, const void* kpool, const void* vpool,
                 const void* start_block, const void* index, void* out,
                 int num_slots, int num_heads, int num_blocks, int block_size,
                 int layer, float scale, void* stream) {
  const dim3 grid(num_slots * num_heads);
  owner_decode_kernel<QT><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(kpool),
      static_cast<const QT*>(vpool), static_cast<const int*>(start_block),
      static_cast<const int*>(index), static_cast<QT*>(out), num_heads,
      num_blocks, block_size, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_stream(const void* q, const void* kpool, const void* vpool,
                  const void* k_scale, const void* v_scale, const void* vis,
                  void* out, int num_slots, int num_heads, int num_blocks,
                  int block_size, int bound, int layer, float scale,
                  void* stream) {
  const dim3 grid(num_slots * num_heads);
  stream_decode_kernel<QT><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const int8_t*>(kpool),
      static_cast<const int8_t*>(vpool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int8_t*>(vis),
      static_cast<QT*>(out), num_heads, num_blocks, block_size, bound, layer,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_table(const void* q, const void* kpool, const void* vpool,
                 const void* tables, const void* index, void* out,
                 int num_slots, int num_heads, int num_blocks, int block_size,
                 int max_blocks, int layer, float scale, void* stream) {
  const dim3 grid(num_slots * num_heads);
  const size_t table_bytes = static_cast<size_t>(max_blocks) * sizeof(int);
  table_decode_kernel<QT><<<grid, kThreads, table_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(kpool),
      static_cast<const QT*>(vpool), static_cast<const int*>(tables),
      static_cast<const int*>(index), static_cast<QT*>(out), num_heads,
      num_blocks, block_size, max_blocks, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError().
extern "C" {

int owner_decode_f32(const void* q, const void* kpool, const void* vpool,
                     const void* start_block, const void* index, void* out,
                     int num_slots, int num_heads, int num_blocks,
                     int block_size, int layer, float scale, void* stream) {
  return launch_owner<float>(q, kpool, vpool, start_block, index, out,
                             num_slots, num_heads, num_blocks, block_size,
                             layer, scale, stream);
}

int owner_decode_bf16(const void* q, const void* kpool, const void* vpool,
                      const void* start_block, const void* index, void* out,
                      int num_slots, int num_heads, int num_blocks,
                      int block_size, int layer, float scale, void* stream) {
  return launch_owner<__nv_bfloat16>(q, kpool, vpool, start_block, index,
                                     out, num_slots, num_heads, num_blocks,
                                     block_size, layer, scale, stream);
}

int owner_decode_q8_f32(const void* q, const void* kpool, const void* vpool,
                        const void* k_scale, const void* v_scale,
                        const void* start_block, const void* index, void* out,
                        int num_slots, int num_heads, int num_blocks,
                        int block_size, int layer, float scale, void* stream) {
  return launch_owner_pipelined<float>(
      q, kpool, vpool, k_scale, v_scale, start_block, index, out, num_slots,
      num_heads, num_blocks, block_size, layer, scale, stream);
}

int owner_decode_q8_bf16(const void* q, const void* kpool, const void* vpool,
                         const void* k_scale, const void* v_scale,
                         const void* start_block, const void* index, void* out,
                         int num_slots, int num_heads, int num_blocks,
                         int block_size, int layer, float scale, void* stream) {
  return launch_owner_pipelined<__nv_bfloat16>(
      q, kpool, vpool, k_scale, v_scale, start_block, index, out, num_slots,
      num_heads, num_blocks, block_size, layer, scale, stream);
}

int stream_decode_f32(const void* q, const void* kpool, const void* vpool,
                      const void* vis, void* out, int num_slots, int num_heads,
                      int num_blocks, int block_size, int bound, int layer,
                      float scale, void* stream) {
  return launch_stream_pipelined<float>(q, kpool, vpool, vis, out,
                                       num_slots, num_heads, num_blocks,
                                       block_size, bound, layer, scale,
                                       stream);
}

int stream_decode_bf16(const void* q, const void* kpool, const void* vpool,
                       const void* vis, void* out, int num_slots,
                       int num_heads, int num_blocks, int block_size,
                       int bound, int layer, float scale, void* stream) {
  return launch_stream_pipelined<__nv_bfloat16>(q, kpool, vpool, vis, out,
                                               num_slots, num_heads,
                                               num_blocks, block_size, bound,
                                               layer, scale, stream);
}

int stream_decode_q8_f32(const void* q, const void* kpool, const void* vpool,
                         const void* k_scale, const void* v_scale,
                         const void* vis, void* out, int num_slots,
                         int num_heads, int num_blocks, int block_size,
                         int bound, int layer, float scale, void* stream) {
  return launch_stream<float>(
      q, kpool, vpool, k_scale, v_scale, vis, out, num_slots, num_heads,
      num_blocks, block_size, bound, layer, scale, stream);
}

int stream_decode_q8_bf16(const void* q, const void* kpool, const void* vpool,
                          const void* k_scale, const void* v_scale,
                          const void* vis, void* out, int num_slots,
                          int num_heads, int num_blocks, int block_size,
                          int bound, int layer, float scale, void* stream) {
  return launch_stream<__nv_bfloat16>(
      q, kpool, vpool, k_scale, v_scale, vis, out, num_slots, num_heads,
      num_blocks, block_size, bound, layer, scale, stream);
}

int table_decode_f32(const void* q, const void* kpool, const void* vpool,
                     const void* tables, const void* index, void* out,
                     int num_slots, int num_heads, int num_blocks,
                     int block_size, int max_blocks, int layer, float scale,
                     void* stream) {
  return launch_table<float>(q, kpool, vpool, tables, index, out, num_slots,
                             num_heads, num_blocks, block_size, max_blocks,
                             layer, scale, stream);
}

int table_decode_bf16(const void* q, const void* kpool, const void* vpool,
                      const void* tables, const void* index, void* out,
                      int num_slots, int num_heads, int num_blocks,
                      int block_size, int max_blocks, int layer, float scale,
                      void* stream) {
  return launch_table<__nv_bfloat16>(q, kpool, vpool, tables, index, out,
                                     num_slots, num_heads, num_blocks,
                                     block_size, max_blocks, layer, scale,
                                     stream);
}

}  // extern "C"
