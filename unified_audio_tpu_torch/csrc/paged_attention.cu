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
// about 10 MB per layer for 16 slots at UniSE's serving prefixes in bf16
// (half that for int8). At 3.35 TB/s that is ~3 us per layer, so the
// kernels are memory-bound. Both designs below run one 256-thread block per
// (slot, head), which fills the SMs one block each at 16 slots, so a
// slot's keys are read by its own SM: what sets the time is how fast one SM
// pulls the longest slot's rows (224 KB a head for 896 bf16 tokens), that
// is how many bytes it keeps in flight and at what rate its loads are
// served. The arithmetic (two dot products of HD per visible key) is
// negligible, so tensor cores are not used: with one query row per (slot,
// head), QK^T and p.v are matrix-vector products at about one operation per
// byte read. The stream kernels also read the visibility mask (S * bound *
// BS bytes), once per head.
//
// The TPU kernels run one grid step per (slot, block) or per chunk of the
// prefix, all heads at once, and carry the softmax state between steps in
// scratch; here the key loop is inside the thread block and the heads are
// split over blocks. The TPU stream kernel walks the prefix in chunks with
// all slots at once; a slot owns a few percent of a serving prefix, so here
// each (slot, head) block of K3 and K4 first finds the physical blocks
// holding any visible key for its slot (16-byte mask loads, a warp ballot
// and a block-wide compaction into shared memory) and reads only those:
// fully masked blocks cost one mask read and no K/V traffic. The Mosaic
// chunk rules (chunk * BS a multiple of 128, the bound divisible by the
// chunk) have no counterpart: the bound is any block count up to the
// pool's.
//
// The tiled design (K1, K7). A tile is min(BS, 64) token rows, this
// head's 64 columns of K and of V (bf16: 8 KB + 8 KB; fp32: 16 + 16 KB), so
// a ring stage never holds more than 32 KB and any block size
// double-buffers. The block stages its tiles in a ring of up to 16 stages
// (192 KB) of dynamic shared memory by cp.async (16 bytes a copy, one
// commit group a tile), as many tiles ahead of the compute as the ring
// holds, so no register holds a byte in flight and a (slot, head) waits on
// the memory about once instead of once per key. The consumer lays lanes
// over the head dimension: a group of lanes holds one key (8 lanes of 16
// bytes for a bf16 row, 16 for fp32), each lane reads its 16-byte word of
// the row from the stage (a warp's reads are contiguous rows, free of bank
// conflicts), the dot product finishes with 3-4 shuffles inside the group,
// and each group keeps an online-softmax state over its lane's columns
// only (8 accumulators for bf16, 4 for fp32: 68-88 registers). The groups'
// states merge by shuffles inside each warp, then through 8 rows of shared
// memory (max, rescale, column sum). K1's tiles are its region's rows
// (contiguous, so a tile may cross blocks); K7's follow its table, a block
// of more than 64 rows cut into tiles that never cross it, and its entries
// are staged 1024 at a time, so the table's width is not limited. The ring
// is opted in to once per device, on the caller's current device, which
// must be the device of the tensors and the stream. On an H100 the tiled
// K1 is slower than the pipelined design alone with the layer warm in L2
// but faster cold and inside the decode step, where it was kept; its time
// is nearly the same warm and cold, as if one SM's load rate, not the
// bytes in flight, set it.
//
// The pipelined design (K2, K3, K4). A thread keeps its own online-softmax
// state (running max, denominator, HD accumulators) in registers for keys
// t, t + 256, ..., holds a key as its raw 16-byte words (the K and V rows
// of its head, the int8 scales, the mask byte) and issues the next key's
// loads before it computes this one: two keys in flight per thread
// (246-255 registers, no spills; fp32 rows, 128 registers a key, go one at
// a time). The dot product runs in four independent sums, int8 values
// become floats by a byte permute into 2^23's mantissa (exact, full rate),
// and the stream kernels load a key's mask byte beside its rows instead of
// before them. The 256 states merge by a reduce-scatter of shuffles in each
// warp (lane L ends with columns 2L, 2L + 1) and one shared-memory row per
// warp. The designs that lost to these (a tiled K4, a split-K K2/K3) are
// recorded in PERF.md, section 6.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;  // head dim the kernels are built for (UniSE LM)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The query row of (slot, head) into shared memory as floats (read as a
// broadcast), which keeps the registers for the K/V rows and the
// accumulators.
template <typename QT>
__device__ __forceinline__ void load_query(const QT* q, int s, int h,
                                           int num_heads, float* qs) {
  const QT* qrow = q + (static_cast<long long>(s) * num_heads + h) * kHeadDim;
  if (threadIdx.x < kHeadDim) qs[threadIdx.x] = to_float(qrow[threadIdx.x]);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The pipelined per-(slot, head) design (K2, K3, K4): see the header.
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

// K3 (KT = QT) and K4 (KT = int8_t): the stream flash decode. Each round
// finds 256 physical blocks' live ones for the slot, then spreads their
// keys over the threads; a key's mask byte is loaded with its rows, and a
// masked key is skipped when it is used.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kPipeThreads, 1)
stream_decode_kernel_pipelined(const QT* __restrict__ q,
                               const KT* __restrict__ kpool,
                               const KT* __restrict__ vpool,
                               const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale,
                               const int8_t* __restrict__ vis,
                               QT* __restrict__ out, int num_heads,
                               int num_blocks, int block_size, int bound,
                               int layer, float scale) {
  constexpr bool kQ8 = sizeof(KT) == 1;
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
    walk_keys<KT, kQ8, true>(
        n_live * block_size,
        [&](int i) {
          return static_cast<long long>(live[i / block_size]) * block_size +
                 i % block_size;
        },
        qs, kpool + layer_off, vpool + layer_off, row, k_scale, v_scale,
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

template <typename QT, typename KT>
int launch_stream_pipelined(const void* q, const void* kpool,
                            const void* vpool, const void* k_scale,
                            const void* v_scale, const void* vis, void* out,
                            int num_slots, int num_heads, int num_blocks,
                            int block_size, int bound, int layer, float scale,
                            void* stream) {
  stream_decode_kernel_pipelined<QT, KT>
      <<<num_slots * num_heads, kPipeThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const QT*>(q), static_cast<const KT*>(kpool),
          static_cast<const KT*>(vpool), static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale), static_cast<const int8_t*>(vis),
          static_cast<QT*>(out), num_heads, num_blocks, block_size, bound,
          layer, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tiled per-(slot, head) design (K1, K7): see the header.
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;  // 8 warps per (slot, head) block
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kMaxTileRows = 64;
constexpr int kMaxStages = 16;
constexpr int kRingBytes = 192 * 1024;  // of the 227 KB a block may opt in to
constexpr int kRound = 1024;  // K7 table entries staged a round

// How a tile of KT rows lies in its ring stage and over the lanes: the
// tile's K rows, then its V rows, kRowBytes each, dense.
template <typename KT>
struct TileLayout {
  static constexpr int kRowBytes = kHeadDim * static_cast<int>(sizeof(KT));
  static constexpr int kLanes = kRowBytes / 16;  // lanes holding one key
  static constexpr int kPerLane = 16 / static_cast<int>(sizeof(KT));
  static constexpr int kGroups = kTileThreads / kLanes;
  static_assert(kMaxTileRows % kGroups == 0, "groups must divide a tile");
  // keys a group takes at once: a 64-row tile in one pass
  static constexpr int kBatch = kMaxTileRows / kGroups;
  __host__ __device__ static constexpr int stage_bytes(int rows) {
    return 2 * rows * kRowBytes;
  }
};
// the widest tile (fp32, 64 rows) is double-buffered: every block size runs
static_assert(kRingBytes / TileLayout<float>::stage_bytes(kMaxTileRows) >= 2,
              "the ring must hold two tiles");

// One tile: its first token row in the layer and its row count.
struct Tile {
  long long first;
  int rows;
};

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char smem[];
  return smem;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's commit groups are pending
// (n <= N; the instruction takes its count as an immediate).
template <int N>
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if constexpr (N == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    if (n >= N) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
    } else {
      cp_async_wait_pending<N - 1>(n);
    }
  }
}

// The online-softmax state of one lane group: the running max, the
// denominator and the p-weighted V sum over the lane's columns.
template <int kPerLane>
struct GroupState {
  float m = -INFINITY;
  float l = 0.f;
  float acc[kPerLane] = {};
};

// The lane's columns of the (slot, head) query row, as floats.
template <typename Lay, typename QT>
__device__ __forceinline__ void load_query_cols(const QT* q, int s, int h,
                                                int num_heads, float* qf) {
  const QT* qrow = q + (static_cast<long long>(s) * num_heads + h) * kHeadDim +
                   (threadIdx.x % Lay::kLanes) * Lay::kPerLane;
#pragma unroll
  for (int e = 0; e < Lay::kPerLane; ++e) qf[e] = to_float(qrow[e]);
}

// One tile of the ring stage `stage` (`rows` of `tile_rows` filled) into
// the state of group g: each group takes keys g, g + kGroups, ..., kBatch
// at a time (their K words read and dot products shuffled together), the
// lane c of the group reading the 16-byte word c of each row.
template <typename KT, typename Lay = TileLayout<KT>>
__device__ __forceinline__ void attend_tile(const unsigned char* stage,
                                            int rows, int tile_rows, int g,
                                            int c, const float* qf,
                                            float scale,
                                            GroupState<Lay::kPerLane>& st) {
  const unsigned char* ks = stage + c * 16;
  const unsigned char* vs = stage + tile_rows * Lay::kRowBytes + c * 16;
  for (int r0 = 0; r0 < rows; r0 += Lay::kGroups * Lay::kBatch) {
    float logit[Lay::kBatch];
    uint4 vw[Lay::kBatch];
#pragma unroll
    for (int b = 0; b < Lay::kBatch; ++b) {
      const int r = r0 + b * Lay::kGroups + g;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u);
      vw[b] = kw;
      if (r < rows) {
        kw = *reinterpret_cast<const uint4*>(ks + r * Lay::kRowBytes);
        vw[b] = *reinterpret_cast<const uint4*>(vs + r * Lay::kRowBytes);
      }
      float kf[Lay::kPerLane];
      word_to_float(kw, kf, static_cast<const KT*>(nullptr));
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < Lay::kPerLane; ++e) {
        part[e & 1] = fmaf(qf[e], kf[e], part[e & 1]);
      }
      logit[b] = part[0] + part[1];
    }
    // the group's lanes sum their columns' parts
#pragma unroll
    for (int off = Lay::kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int b = 0; b < Lay::kBatch; ++b) {
        logit[b] += __shfl_xor_sync(0xffffffffu, logit[b], off);
      }
    }
    float big = -INFINITY;
#pragma unroll
    for (int b = 0; b < Lay::kBatch; ++b) {
      const bool in = r0 + b * Lay::kGroups + g < rows;
      logit[b] = in ? logit[b] * scale : -INFINITY;
      big = fmaxf(big, logit[b]);
    }
    if (big == -INFINITY) continue;  // the group's rows end before the batch
    const float m_new = fmaxf(st.m, big);
    const float alpha = expf(st.m - m_new);  // 0 on the first key (m = -inf)
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < Lay::kPerLane; ++e) st.acc[e] *= alpha;
#pragma unroll
    for (int b = 0; b < Lay::kBatch; ++b) {
      if (logit[b] == -INFINITY) continue;  // past the tile
      const float p = expf(logit[b] - m_new);
      psum += p;
      float vf[Lay::kPerLane];
      word_to_float(vw[b], vf, static_cast<const KT*>(nullptr));
#pragma unroll
      for (int e = 0; e < Lay::kPerLane; ++e) {
        st.acc[e] = fmaf(p, vf[e], st.acc[e]);
      }
    }
    st.l = st.l * alpha + psum;
    st.m = m_new;
  }
}

// Tiles 0..n_tiles-1 (tile_of(j) -> Tile) into the groups' states through
// the ring of `stages` stages: tiles j + 1 .. j + stages - 1 are in flight
// while tile j is computed. kbase/vbase: the layer's pool offset to this
// head's columns, `row` elements a token row.
template <typename KT, typename TileOf, typename Lay = TileLayout<KT>>
__device__ __forceinline__ void walk_tiles(int n_tiles, TileOf tile_of,
                                           int tile_rows, int stages,
                                           const float* qf, const KT* kbase,
                                           const KT* vbase, long long row,
                                           float scale,
                                           GroupState<Lay::kPerLane>& st) {
  unsigned char* ring = dynamic_smem();
  const int stage_bytes = Lay::stage_bytes(tile_rows);
  const int t = threadIdx.x;

  // every thread copies its share of tile j's K and V rows and commits one
  // group (an empty one past the last tile, so that the counts stay
  // aligned)
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const Tile tile = tile_of(j);
      unsigned char* dst = ring + (j % stages) * stage_bytes;
      for (int i = t; i < tile.rows * Lay::kLanes; i += kTileThreads) {
        const int r = i / Lay::kLanes;
        const int w = i % Lay::kLanes;
        const long long src = (tile.first + r) * row + w * Lay::kPerLane;
        const int at = r * Lay::kRowBytes + w * 16;
        cp_async16(dst + at, kbase + src);
        cp_async16(dst + tile_rows * Lay::kRowBytes + at, vbase + src);
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < stages - 1; ++j) issue(j);
  const int g = t / Lay::kLanes;
  const int c = t % Lay::kLanes;
  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed once at most stages - 2 of this thread's groups
    // are pending; the barrier shows every thread's copies and frees the
    // stage of tile j - 1, which tile j + stages - 1 takes
    cp_async_wait_pending<kMaxStages - 2>(stages - 2);
    __syncthreads();
    issue(j + stages - 1);
    attend_tile<KT>(ring + (j % stages) * stage_bytes, tile_of(j).rows,
                    tile_rows, g, c, qf, scale, st);
  }
  cp_async_wait_pending<0>(0);
  __syncthreads();  // the ring and the caller's tile list are rewritten next
}

// Merge the groups' states and write the (slot, head) output row; zeros
// where no group saw a key. The groups of a warp merge by shuffles (each
// step joins the groups kLanes, 2 kLanes, ... lanes apart), then 64 threads
// merge the 8 warps' rows: the global max, each row rescaled, a column sum.
template <typename Lay, typename QT>
__device__ __forceinline__ void merge_store_tiled(
    GroupState<Lay::kPerLane>& st, QT* orow) {
  __shared__ float warp_m[kTileWarps];
  __shared__ float warp_l[kTileWarps];
  __shared__ float warp_acc[kTileWarps][kHeadDim];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int off = Lay::kLanes; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, st.m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, st.l, off);
    const float big = fmaxf(st.m, m_o);
    const float f = st.m == -INFINITY ? 0.f : expf(st.m - big);
    const float f_o = m_o == -INFINITY ? 0.f : expf(m_o - big);
    st.l = st.l * f + l_o * f_o;
#pragma unroll
    for (int e = 0; e < Lay::kPerLane; ++e) {
      const float a_o = __shfl_xor_sync(0xffffffffu, st.acc[e], off);
      st.acc[e] = st.acc[e] * f + a_o * f_o;
    }
    st.m = big;
  }
  if (lane < Lay::kLanes) {
#pragma unroll
    for (int e = 0; e < Lay::kPerLane; ++e) {
      warp_acc[warp][lane * Lay::kPerLane + e] = st.acc[e];
    }
  }
  if (lane == 0) {
    warp_m[warp] = st.m;
    warp_l[warp] = st.l;
  }
  __syncthreads();
  if (t < kHeadDim) {
    float big = warp_m[0];
#pragma unroll
    for (int w = 1; w < kTileWarps; ++w) big = fmaxf(big, warp_m[w]);
    if (big == -INFINITY) {  // no visible key: an inactive or empty row
      store(orow + t, 0.f);
      return;
    }
    float total = 0.f;
    float denom = 0.f;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const float f = expf(warp_m[w] - big);  // 0 for a warp with no key
      total += warp_acc[w][t] * f;
      denom += warp_l[w] * f;
    }
    store(orow + t, total * (1.f / denom));
  }
}

// K1: the owner flash decode over a bf16 or fp32 pool; the slot's
// positions 0..index[s] are the contiguous rows from start_block[s] * BS,
// cut into tiles of tile_rows.
template <typename QT, typename Lay = TileLayout<QT>>
__global__ void __launch_bounds__(kTileThreads, 1)
owner_decode_kernel_tiled(const QT* __restrict__ q,
                          const QT* __restrict__ kpool,
                          const QT* __restrict__ vpool,
                          const int* __restrict__ start_block,
                          const int* __restrict__ index, QT* __restrict__ out,
                          int num_heads, int num_blocks, int block_size,
                          int tile_rows, int stages, int layer, float scale) {
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const long long row = static_cast<long long>(num_heads) * kHeadDim;
  const long long layer_off =
      static_cast<long long>(layer) * num_blocks * block_size * row +
      static_cast<long long>(h) * kHeadDim;
  const long long first = static_cast<long long>(start_block[s]) * block_size;
  const int n = max(index[s] + 1, 0);
  float qf[Lay::kPerLane];
  load_query_cols<Lay>(q, s, h, num_heads, qf);
  GroupState<Lay::kPerLane> st;
  walk_tiles<QT>(
      (n + tile_rows - 1) / tile_rows,
      [&](int j) {
        return Tile{first + static_cast<long long>(j) * tile_rows,
                    min(tile_rows, n - j * tile_rows)};
      },
      tile_rows, stages, qf, kpool + layer_off, vpool + layer_off, row,
      scale, st);
  merge_store_tiled<Lay>(
      st, out + (static_cast<long long>(s) * num_heads + h) * kHeadDim);
}

// K7: the block-table flash decode over a bf16 or fp32 pool; positions
// 0..min(index[s], MB * BS - 1), position p at row p % BS of block
// tables[s, p / BS]. The table entries those positions reach are staged
// kRound at a time; a block is cut into ceil(BS / tile_rows) tiles, none
// crossing into the next block.
template <typename QT, typename Lay = TileLayout<QT>>
__global__ void __launch_bounds__(kTileThreads, 1)
table_decode_kernel_tiled(const QT* __restrict__ q,
                          const QT* __restrict__ kpool,
                          const QT* __restrict__ vpool,
                          const int* __restrict__ tables,
                          const int* __restrict__ index, QT* __restrict__ out,
                          int num_heads, int num_blocks, int block_size,
                          int max_blocks, int tile_rows, int stages, int layer,
                          float scale) {
  __shared__ int entry[kRound];
  const int s = blockIdx.x / num_heads;
  const int h = blockIdx.x % num_heads;
  const long long row = static_cast<long long>(num_heads) * kHeadDim;
  const long long layer_off =
      static_cast<long long>(layer) * num_blocks * block_size * row +
      static_cast<long long>(h) * kHeadDim;
  // the TPU grid covers the table's blocks only: positions past it are not
  // attended, whatever the index
  const int n = static_cast<int>(
      max(min(static_cast<long long>(index[s]) + 1,
              static_cast<long long>(max_blocks) * block_size),
          0LL));
  const int n_entries = (n + block_size - 1) / block_size;
  const int* slot_table = tables + static_cast<long long>(s) * max_blocks;
  float qf[Lay::kPerLane];
  load_query_cols<Lay>(q, s, h, num_heads, qf);
  GroupState<Lay::kPerLane> st;
  for (int e0 = 0; e0 < n_entries; e0 += kRound) {
    const int count = min(kRound, n_entries - e0);
    for (int i = threadIdx.x; i < count; i += kTileThreads) {
      entry[i] = slot_table[e0 + i];
    }
    __syncthreads();
    // this round's positions, from e0 * BS: per_block tiles a full block,
    // the last block's tiles cut where its positions end
    const int n_round = min(count * block_size, n - e0 * block_size);
    const int per_block = (block_size + tile_rows - 1) / tile_rows;
    const int tail = n_round % block_size;
    walk_tiles<QT>(
        n_round / block_size * per_block + (tail + tile_rows - 1) / tile_rows,
        [&](int j) {
          // blocks of at most 64 rows: one tile a block, without the
          // division, which cost ~1 us a call at 64-token blocks (PERF.md)
          if (per_block == 1) {
            return Tile{static_cast<long long>(entry[j]) * block_size,
                        min(block_size, n_round - j * block_size)};
          }
          const int b = j / per_block;
          const int off = (j % per_block) * tile_rows;
          return Tile{static_cast<long long>(entry[b]) * block_size + off,
                      min(min(tile_rows, block_size - off),
                          n_round - b * block_size - off)};
        },
        tile_rows, stages, qf, kpool + layer_off, vpool + layer_off, row,
        scale, st);
  }
  merge_store_tiled<Lay>(
      st, out + (static_cast<long long>(s) * num_heads + h) * kHeadDim);
}

// Rows of a tile: a physical block's, at most 64.
int tile_rows_for(int block_size) { return min(block_size, kMaxTileRows); }

// The ring of a tiled launch: as many stages as kRingBytes holds, at most
// kMaxStages (at least 2, by the static_assert above).
template <typename Lay>
int ring_stages(int tile_rows, size_t* bytes) {
  const int per_stage = Lay::stage_bytes(tile_rows);
  const int stages = min(kMaxStages, kRingBytes / per_stage);
  *bytes = static_cast<size_t>(stages) * per_stage;
  return stages;
}

constexpr int kMaxDevices = 64;

// Opt the kernel in to the ring's dynamic shared memory (above the 48 KB a
// block gets without asking) on the current device, once per device:
// `opted` is the kernel's own flag per device.
template <typename Kernel>
int opt_in(Kernel kernel, bool* opted) {
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev < kMaxDevices && opted[dev]) return 0;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (set == cudaSuccess && dev < kMaxDevices) opted[dev] = true;
  return static_cast<int>(set);
}

template <typename QT>
int launch_owner_tiled(const void* q, const void* kpool, const void* vpool,
                       const void* start_block, const void* index, void* out,
                       int num_slots, int num_heads, int num_blocks,
                       int block_size, int layer, float scale, void* stream) {
  static bool opted[kMaxDevices] = {};
  const int rc = opt_in(owner_decode_kernel_tiled<QT>, opted);
  if (rc != 0) return rc;
  const int rows = tile_rows_for(block_size);
  size_t bytes = 0;
  const int stages = ring_stages<TileLayout<QT>>(rows, &bytes);
  owner_decode_kernel_tiled<QT><<<num_slots * num_heads, kTileThreads, bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(kpool),
      static_cast<const QT*>(vpool), static_cast<const int*>(start_block),
      static_cast<const int*>(index), static_cast<QT*>(out), num_heads,
      num_blocks, block_size, rows, stages, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_table_tiled(const void* q, const void* kpool, const void* vpool,
                       const void* tables, const void* index, void* out,
                       int num_slots, int num_heads, int num_blocks,
                       int block_size, int max_blocks, int layer, float scale,
                       void* stream) {
  static bool opted[kMaxDevices] = {};
  const int rc = opt_in(table_decode_kernel_tiled<QT>, opted);
  if (rc != 0) return rc;
  const int rows = tile_rows_for(block_size);
  size_t bytes = 0;
  const int stages = ring_stages<TileLayout<QT>>(rows, &bytes);
  table_decode_kernel_tiled<QT><<<num_slots * num_heads, kTileThreads, bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(kpool),
      static_cast<const QT*>(vpool), static_cast<const int*>(tables),
      static_cast<const int*>(index), static_cast<QT*>(out), num_heads,
      num_blocks, block_size, max_blocks, rows, stages, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns cudaGetLastError().
extern "C" {

int owner_decode_f32(const void* q, const void* kpool, const void* vpool,
                     const void* start_block, const void* index, void* out,
                     int num_slots, int num_heads, int num_blocks,
                     int block_size, int layer, float scale, void* stream) {
  return launch_owner_tiled<float>(q, kpool, vpool, start_block, index, out,
                                   num_slots, num_heads, num_blocks,
                                   block_size, layer, scale, stream);
}

int owner_decode_bf16(const void* q, const void* kpool, const void* vpool,
                      const void* start_block, const void* index, void* out,
                      int num_slots, int num_heads, int num_blocks,
                      int block_size, int layer, float scale, void* stream) {
  return launch_owner_tiled<__nv_bfloat16>(q, kpool, vpool, start_block,
                                           index, out, num_slots, num_heads,
                                           num_blocks, block_size, layer,
                                           scale, stream);
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
  return launch_stream_pipelined<float, float>(
      q, kpool, vpool, nullptr, nullptr, vis, out, num_slots, num_heads,
      num_blocks, block_size, bound, layer, scale, stream);
}

int stream_decode_bf16(const void* q, const void* kpool, const void* vpool,
                       const void* vis, void* out, int num_slots,
                       int num_heads, int num_blocks, int block_size,
                       int bound, int layer, float scale, void* stream) {
  return launch_stream_pipelined<__nv_bfloat16, __nv_bfloat16>(
      q, kpool, vpool, nullptr, nullptr, vis, out, num_slots, num_heads,
      num_blocks, block_size, bound, layer, scale, stream);
}

int stream_decode_q8_f32(const void* q, const void* kpool, const void* vpool,
                         const void* k_scale, const void* v_scale,
                         const void* vis, void* out, int num_slots,
                         int num_heads, int num_blocks, int block_size,
                         int bound, int layer, float scale, void* stream) {
  return launch_stream_pipelined<float, int8_t>(
      q, kpool, vpool, k_scale, v_scale, vis, out, num_slots, num_heads,
      num_blocks, block_size, bound, layer, scale, stream);
}

int stream_decode_q8_bf16(const void* q, const void* kpool, const void* vpool,
                          const void* k_scale, const void* v_scale,
                          const void* vis, void* out, int num_slots,
                          int num_heads, int num_blocks, int block_size,
                          int bound, int layer, float scale, void* stream) {
  return launch_stream_pipelined<__nv_bfloat16, int8_t>(
      q, kpool, vpool, k_scale, v_scale, vis, out, num_slots, num_heads,
      num_blocks, block_size, bound, layer, scale, stream);
}

int table_decode_f32(const void* q, const void* kpool, const void* vpool,
                     const void* tables, const void* index, void* out,
                     int num_slots, int num_heads, int num_blocks,
                     int block_size, int max_blocks, int layer, float scale,
                     void* stream) {
  return launch_table_tiled<float>(q, kpool, vpool, tables, index, out,
                                   num_slots, num_heads, num_blocks,
                                   block_size, max_blocks, layer, scale,
                                   stream);
}

int table_decode_bf16(const void* q, const void* kpool, const void* vpool,
                      const void* tables, const void* index, void* out,
                      int num_slots, int num_heads, int num_blocks,
                      int block_size, int max_blocks, int layer, float scale,
                      void* stream) {
  return launch_table_tiled<__nv_bfloat16>(q, kpool, vpool, tables, index,
                                           out, num_slots, num_heads,
                                           num_blocks, block_size, max_blocks,
                                           layer, scale, stream);
}

}  // extern "C"
