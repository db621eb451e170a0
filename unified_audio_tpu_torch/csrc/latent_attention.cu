// K8: latent attention for Hopper (sm_90a), the Moonlight stack's
// multi-head latent attention (MLA) in the absorbed form, over the latent
// rows where they lie: a serving pool's blocks through each slot's block
// table (the decode step) or a dense cache's run of positions (the prefill
// and the offline decode).
//
// Replaces no TPU kernel: the JAX package has no latent attention (the
// Moonlight backbone is the port's own, models/lm/moonlight.py). It replaces
// the plain absorbed attention on the card (ops/cuda/latent_attention.py
// latent_attention_ref): a gather of every slot's whole table of rows into a
// copy, bf16 logits over all of them, fp32 scale, mask and softmax passes,
// and two batched products over the copy.
//
// What it computes. Query row (b, s, h) is the absorbed query [q_nope W_uk,
// q_pe] of head h (C = rank + rope wide, the rows' dtype, bf16). It sits at
// position pos0[b] + s and sees the keys t <= pos0[b] + s (and t < kmax, the
// keys its table or cache holds); key t of batch row b is latent row
//   tables[b, t / BS] * BS + t % BS   of the layer (a block table), or
//   b * kmax + t                      of the layer (a dense cache, no table).
// out[b, s, h] = softmax_t(scale * q . row_t) . row_t[:R], R = rank: fp32
// logits, fp32 running max and sum, the probabilities rounded to bf16 for the
// p.v product, fp32 accumulation, the output rounded to bf16 once. A batch
// row with pos0 < 0 (an inactive slot) returns zeros and reads nothing.
//
// What bounds it on this card. The decode step reads each slot's live rows
// once, 1,152 bytes a row (Moonlight: 576 bf16) shared by all 16 heads: ~33
// MB a layer at the serving cell's ~456 live rows of 64 slots, ~10 us at
// 3.35 TB/s, against ~1 GFLOP (two products of 16 heads per row) that the
// tensor cores do in ~1 us. So the decode is memory-bound and the design
// keeps enough rows in flight on every SM; it splits each slot's keys over
// blocks of `split_keys` keys (128, or a multiple of 128 that keeps the
// splits at 64 past 8,192 keys; the split fixed by the table's or cache's
// length, so a captured CUDA graph replays any mix of lengths) and merges
// the splits' states in a second small kernel. The prefill (64 rows of 504 positions,
// causal) is ~283 GFLOP a layer over ~37 MB: compute-bound, so its tile
// holds 4 positions x 16 heads = 64 query rows, which every key row loaded
// serves.
//
// The design. One block of 8 warps holds its query tile (16 rows for the
// decode, 64 for the prefill; 4-head stacks pad the decode's to 16) in
// shared memory and walks its key range in sub-tiles of 32 rows, staged by
// cp.async in a ring of two (a sub-tile never crosses a table block, since
// the block size is a multiple of 32: one table read per sub-tile's row).
// Rows past the block's last visible key are zero-filled, never read. Per
// sub-tile: q.k^T with mma.sync m16n8k16 (bf16 in, fp32 out; fragments by
// ldmatrix), each warp a pair of n8 score tiles over its share of the C
// depth (the decode's 16 rows split the depth in four), into a score tile
// in shared memory; an online softmax per row over a group of lanes (16
// lanes of 2 keys for the decode, 4 lanes of 8 for the prefill); then each
// warp rescales its fp32 accumulators (its pairs of n8 output columns, all
// rows: 64 of Moonlight's 512 columns) and adds p.v, the value rows being
// the same staged key rows' first R columns, read transposed by ldmatrix.
// Row strides are padded by 8 bf16, so the eight rows of an ldmatrix fall
// on distinct banks. The decode's splits are merged one block a (slot,
// head), 4 columns a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;         // key rows a sub-tile
constexpr int kMaxSplits = 64;    // decode blocks a batch row, at most
constexpr int kPad = 8;           // bf16 padding of a shared row
constexpr int kMaxDevices = 64;
constexpr int kMergeThreads = 128;  // 4 columns a thread: Moonlight's 512

template <int H, int C, int R, int QP>
struct Shape {
  static constexpr int kStages = 2;  // sub-tiles in the ring
  static constexpr int kRows = (QP * H + 15) / 16 * 16;  // query rows, padded
  static constexpr int kRowTiles = kRows / 16;
  static constexpr int kCP = C + kPad;       // stride of a q or key row
  static constexpr int kPP = kKeys + kPad;   // stride of a probability row
  static constexpr int kSP = kKeys + 4;      // stride of a score row (fp32)
  static constexpr int kDepth = C / 16;      // k-steps of q.k
  // q.k: a warp takes a pair of n8 score tiles of one row tile, over a
  // share of the depth
  static constexpr int kScorePairs = kRowTiles * kKeys / 16;
  static constexpr int kDepthSplit = kWarps / kScorePairs;
  // p.v: a warp takes pairs of n8 output tiles (all row tiles)
  static constexpr int kOutPairs = R / 16;
  static constexpr int kOutPairsPerWarp = (kOutPairs + kWarps - 1) / kWarps;
  // softmax: a warp takes kRows / 8 rows, kLanes lanes a row, kPerLane keys
  // a lane
  static constexpr int kLanes = 32 * kWarps / kRows;
  static constexpr int kPerLane = kKeys / kLanes;
  static constexpr int kQBytes = kRows * kCP * 2;
  static constexpr int kKBytes = kStages * kKeys * kCP * 2;
  static constexpr int kSBytes = kDepthSplit * kRows * kSP * 4;
  static constexpr int kPBytes = kRows * kPP * 2;
  static constexpr int kStateBytes = 2 * kRows * 4;  // alpha and l per row
  static constexpr int kBytes =
      kQBytes + kKBytes + kSBytes + kPBytes + kStateBytes;
  static_assert(C % 16 == 0 && R % 16 == 0 && R <= C, "latent widths");
  static_assert(kWarps % kScorePairs == 0, "score pairs over warps");
  static_assert(kLanes * kRows == 32 * kWarps && kPerLane * kLanes == kKeys,
                "softmax rows over lanes");
  static_assert((kCP * 2) % 16 == 0 && (kPP * 2) % 16 == 0 &&
                    kQBytes % 16 == 0 && kKBytes % 16 == 0 &&
                    kSBytes % 16 == 0 && kPBytes % 16 == 0,
                "16-byte rows and regions");
};

// Where a batch row's keys lie.
struct Keys {
  const bf16* rows;    // the layer's rows (NB * BS, or B * kmax, of C)
  const int* tables;   // (B, max_blocks) block tables, or null: dense
  int max_blocks;
  int block_size;
  int kmax;            // keys a batch row holds: max_blocks * BS, or T
};

// The layer row of key t of batch row b.
__device__ __forceinline__ long long key_row(const Keys& k, int b, int t) {
  if (k.tables == nullptr) return static_cast<long long>(b) * k.kmax + t;
  const int blk = __ldg(k.tables + static_cast<long long>(b) * k.max_blocks +
                        t / k.block_size);
  return static_cast<long long>(blk) * k.block_size + t % k.block_size;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, lane L giving the address
// of row L % 8 of matrix L / 8; lane L receives row L / 4, columns 2 (L %
// 4) and + 1 of each (transposed: column L / 4, rows 2 (L % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate.
// a: the fragment (a0..a3) of a 16 x 16 tile; b: (b0, b1) of a 16 x 8.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Max and sum over the N lanes of an aligned group.
template <int N>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int N>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage key rows t0 .. t0 + 31 into dst; rows past `last` are zero-filled.
template <int C, int CP>
__device__ __forceinline__ void stage_keys(bf16* dst, const Keys& k, int b,
                                           int t0, int last) {
  constexpr int kChunksPerRow = C / 8;
  const long long base = key_row(k, b, t0);  // t0 .. t0 + 31: one run
  for (int i = threadIdx.x; i < kKeys * kChunksPerRow; i += kThreads) {
    const int r = i / kChunksPerRow, c = i % kChunksPerRow;
    const bool live = t0 + r <= last;
    const bf16* src = k.rows + (live ? (base + r) * C + c * 8 : 0);
    cp_async16(dst + r * CP + c * 8, src, live ? 16 : 0);
  }
}

// One block: batch row blockIdx.x; for the decode (QP == 1) the keys
// [split_keys * blockIdx.y, +split_keys) of its one query position, for the prefill the
// query positions [QP * tile, +QP) over all their keys. With `part_acc` the
// block writes its split's unnormalized state for the merge, else the
// normalized output.
template <int H, int C, int R, int QP>
__global__ void __launch_bounds__(kThreads, QP == 1 ? 2 : 1)
    latent_attention_kernel(const bf16* __restrict__ q, Keys keys,
                            const int* __restrict__ pos0, int seq,
                            int splits, int split_keys, float scale_log2,
                            bf16* __restrict__ out,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml) {
  using S = Shape<H, C, R, QP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::kQBytes);
  float* ss = reinterpret_cast<float*>(smem + S::kQBytes + S::kKBytes);
  bf16* ps = reinterpret_cast<bf16*>(smem + S::kQBytes + S::kKBytes +
                                     S::kSBytes);
  float* alpha_s = reinterpret_cast<float*>(
      smem + S::kQBytes + S::kKBytes + S::kSBytes + S::kPBytes);
  float* l_s = alpha_s + S::kRows;

  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // the prefill's longest query tiles (the last) are scheduled first
  const int tile = QP == 1 ? 0 : gridDim.y - 1 - blockIdx.y;
  const int split = QP == 1 ? blockIdx.y : 0;
  const int s0 = tile * QP;
  const int p0 = pos0[b];
  const int last = p0 < 0 ? -1 : min(p0 + min(s0 + QP, seq) - 1,
                                      keys.kmax - 1);
  const int kbegin = split * split_keys;
  const int kend = QP == 1 ? min(last + 1, kbegin + split_keys) : last + 1;
  const bool direct = part_acc == nullptr;

  // the last visible key of query row r (-1: a padding row)
  auto row_last = [&](int r) {
    const int s = s0 + r / H;
    if (r >= QP * H || s >= seq || p0 < 0) return -1;
    return min(p0 + s, keys.kmax - 1);
  };

  if (kbegin >= kend) {  // no key here: zeros, or nothing for the merge
    if (direct) {
      for (int i = threadIdx.x; i < QP * H * R; i += kThreads) {
        const int r = i / R, s = s0 + r / H;
        if (s < seq)
          out[((static_cast<long long>(b) * seq + s) * H + r % H) * R +
              i % R] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  // the query tile, padding rows zero
  constexpr int kQChunks = C / 8;
  for (int i = threadIdx.x; i < S::kRows * kQChunks; i += kThreads) {
    const int r = i / kQChunks, c = i % kQChunks;
    const int s = s0 + r / H;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < QP * H && s < seq) {
      v = *reinterpret_cast<const uint4*>(
          q + ((static_cast<long long>(b) * seq + s) * H + r % H) * C +
          c * 8);
    }
    *reinterpret_cast<uint4*>(qs + r * S::kCP + c * 8) = v;
  }

  const int n = (kend - kbegin + kKeys - 1) / kKeys;
#pragma unroll
  for (int i = 0; i < S::kStages - 1; ++i) {
    if (i < n)
      stage_keys<C, S::kCP>(ks + (i % S::kStages) * kKeys * S::kCP, keys, b,
                            kbegin + i * kKeys, last);
    cp_async_commit();
  }

  // the ldmatrix lane's matrix and row in it
  const int m8 = lane >> 3, i8 = lane & 7;
  // q.k: this warp's pair of score tiles and share of the depth
  const int pair = warp % S::kScorePairs, part = warp / S::kScorePairs;
  const int srt = pair / 2, snt = (pair % 2) * 2;
  const int k0 = part * S::kDepth / S::kDepthSplit;
  const int k1 = (part + 1) * S::kDepth / S::kDepthSplit;
  const bf16* qa = qs + (srt * 16 + i8 + (m8 & 1) * 8) * S::kCP + (m8 >> 1) * 8;
  // softmax: this lane's row and keys
  const int srow = warp * (S::kRows / kWarps) + lane / S::kLanes;
  const int skey = (lane % S::kLanes) * S::kPerLane;
  const int my_last = row_last(srow);
  float m_row = -INFINITY, l_row = 0.f;

  float acc[S::kRowTiles][2 * S::kOutPairsPerWarp][4];
#pragma unroll
  for (int rt = 0; rt < S::kRowTiles; ++rt)
#pragma unroll
    for (int i = 0; i < 2 * S::kOutPairsPerWarp; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][i][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int ahead = it + S::kStages - 1;
    if (ahead < n)
      stage_keys<C, S::kCP>(ks + (ahead % S::kStages) * kKeys * S::kCP, keys, b,
                            kbegin + ahead * kKeys, last);
    cp_async_commit();
    cp_async_wait<S::kStages - 1>();
    __syncthreads();
    const bf16* kt = ks + (it % S::kStages) * kKeys * S::kCP;
    const int t0 = kbegin + it * kKeys;

    // 1. scores: q . k^T, two n8 tiles over this warp's share of the depth
    {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* kb =
          kt + ((snt + (m8 >> 1)) * 8 + i8) * S::kCP + (m8 & 1) * 8;
      for (int kk = k0; kk < k1; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, qa + kk * 16);
        ldsm_x4(bb, kb + kk * 16);
        mma(c[0], a, bb[0], bb[1]);
        mma(c[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* sp = ss + (part * S::kRows + srt * 16 + g) * S::kSP +
                    (snt + j) * 8 + 2 * t4;
        sp[0] = c[j][0];
        sp[1] = c[j][1];
        sp[8 * S::kSP] = c[j][2];
        sp[8 * S::kSP + 1] = c[j][3];
      }
    }
    __syncthreads();

    // 2. online softmax: kLanes lanes a row, kPerLane keys a lane
    {
      float x[S::kPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < S::kPerLane; ++e) {
        float v = 0.f;
#pragma unroll
        for (int d = 0; d < S::kDepthSplit; ++d)
          v += ss[(d * S::kRows + srow) * S::kSP + skey + e];
        x[e] = t0 + skey + e <= my_last ? v * scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      const float m_new = fmaxf(m_row, group_max<S::kLanes>(mx));
      float alpha = 1.f, psum = 0.f;
      __align__(16) bf16 pb[S::kPerLane];
#pragma unroll
      for (int e = 0; e < S::kPerLane; ++e) {
        const float p = m_new == -INFINITY ? 0.f : exp2f(x[e] - m_new);
        psum += p;
        pb[e] = __float2bfloat16(p);
      }
      if (m_new != -INFINITY) alpha = exp2f(m_row - m_new);
      l_row = l_row * alpha + group_sum<S::kLanes>(psum);
      m_row = m_new;
      bf16* pd = ps + srow * S::kPP + skey;
      if constexpr (S::kPerLane == 8) {
        *reinterpret_cast<uint4*>(pd) = *reinterpret_cast<const uint4*>(pb);
      } else {
#pragma unroll
        for (int e = 0; e < S::kPerLane; ++e) pd[e] = pb[e];
      }
      if (skey == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

    // 3. rescale, then p . v over this warp's pairs of output tiles
#pragma unroll
    for (int rt = 0; rt < S::kRowTiles; ++rt) {
      const float lo = alpha_s[rt * 16 + g], hi = alpha_s[rt * 16 + g + 8];
#pragma unroll
      for (int i = 0; i < 2 * S::kOutPairsPerWarp; ++i) {
        acc[rt][i][0] *= lo;
        acc[rt][i][1] *= lo;
        acc[rt][i][2] *= hi;
        acc[rt][i][3] *= hi;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[S::kRowTiles][4];
#pragma unroll
      for (int rt = 0; rt < S::kRowTiles; ++rt)
        ldsm_x4(a[rt], ps + (rt * 16 + i8 + (m8 & 1) * 8) * S::kPP +
                           kk * 16 + (m8 >> 1) * 8);
#pragma unroll
      for (int i = 0; i < S::kOutPairsPerWarp; ++i) {
        const int op = warp + kWarps * i;
        if (op < S::kOutPairs) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, kt + (kk * 16 + (m8 & 1) * 8 + i8) * S::kCP +
                                op * 16 + (m8 >> 1) * 8);
#pragma unroll
          for (int rt = 0; rt < S::kRowTiles; ++rt) {
            mma(acc[rt][2 * i], a[rt], bb[0], bb[1]);
            mma(acc[rt][2 * i + 1], a[rt], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // the ring slot, scores and probabilities are reused
  }
  cp_async_wait<0>();

  // the rows' states: (max, sum) to the merge, the sums to the epilogue
  if (skey == 0) {
    l_s[srow] = l_row;
    if (!direct && srow < H) {
      float* ml = part_ml +
                  ((static_cast<long long>(b) * splits + split) * H + srow) * 2;
      ml[0] = m_row;
      ml[1] = l_row;
    }
  }
  __syncthreads();

#pragma unroll
  for (int rt = 0; rt < S::kRowTiles; ++rt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rt * 16 + g + 8 * half;
      const int s = s0 + r / H;
      if (r >= QP * H || s >= seq) continue;
      const float inv = l_s[r] > 0.f ? 1.f / l_s[r] : 0.f;
#pragma unroll
      for (int i = 0; i < 2 * S::kOutPairsPerWarp; ++i) {
        const int op = warp + kWarps * (i / 2);
        if (op >= S::kOutPairs) continue;
        const int col = op * 16 + (i % 2) * 8 + 2 * t4;
        const float v0 = acc[rt][i][2 * half], v1 = acc[rt][i][2 * half + 1];
        if (direct) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((static_cast<long long>(b) * seq + s) * H + r % H) * R +
              col) = __floats2bfloat162_rn(v0 * inv, v1 * inv);
        } else {
          *reinterpret_cast<float2*>(
              part_acc +
              ((static_cast<long long>(b) * splits + split) * H + r) * R +
              col) = make_float2(v0, v1);
        }
      }
    }
  }
}

// The decode's splits merged, one block a (slot, head), 4 columns a
// thread: out[b, h] = sum over the live splits s of 2^(m_s - M) acc_s /
// sum of 2^(m_s - M) l_s, M the largest m_s; zeros for an inactive slot.
template <int H, int R>
__global__ void __launch_bounds__(kMergeThreads)
    latent_split_merge_kernel(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              const int* __restrict__ pos0, int kmax,
                              int splits, int split_keys,
                              bf16* __restrict__ out) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int p0 = pos0[b];
  const int live = p0 < 0 ? 0 : min(p0, kmax - 1) / split_keys + 1;
  const long long at = static_cast<long long>(b) * splits * H + h;
  const float* ml = part_ml + at * 2;  // split s at + 2 H s
  float big = -INFINITY;
  for (int s = 0; s < live; ++s) big = fmaxf(big, ml[2 * H * s]);
  float sum = 0.f;
  for (int s = 0; s < live; ++s)
    sum += exp2f(ml[2 * H * s] - big) * ml[2 * H * s + 1];
  const float inv = live ? 1.f / sum : 0.f;
  for (int col = threadIdx.x * 4; col < R; col += kMergeThreads * 4) {
    const float* acc = part_acc + at * R + col;  // split s at + H R s
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < live; ++s) {
      const float w = exp2f(ml[2 * H * s] - big);
      const float4 a =
          *reinterpret_cast<const float4*>(acc + static_cast<long long>(s) *
                                                     H * R);
      v.x += w * a.x;
      v.y += w * a.y;
      v.z += w * a.z;
      v.w += w * a.w;
    }
    bf16* o = out + (static_cast<long long>(b) * H + h) * R + col;
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __floats2bfloat162_rn(v.x * inv, v.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(o + 2) =
        __floats2bfloat162_rn(v.z * inv, v.w * inv);
  }
}

// Opt a kernel in to its shared memory (above the 48 KB a block gets
// without asking) on the current device, once per device.
template <typename Kernel>
int opt_in(Kernel kernel, int bytes, bool* opted) {
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev < kMaxDevices && opted[dev]) return 0;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set == cudaSuccess && dev < kMaxDevices) opted[dev] = true;
  return static_cast<int>(set);
}

template <int H, int C, int R, int QP>
int launch_tiles(const bf16* q, const Keys& keys, const int* pos0, bf16* out,
                 float* part_acc, float* part_ml, int batch, int seq,
                 int splits, int split_keys, float scale_log2,
                 cudaStream_t stream) {
  static bool opted[kMaxDevices] = {};
  using S = Shape<H, C, R, QP>;
  const int rc = opt_in(latent_attention_kernel<H, C, R, QP>, S::kBytes,
                        opted);
  if (rc != 0) return rc;
  const dim3 grid(batch, QP == 1 ? splits : (seq + QP - 1) / QP);
  latent_attention_kernel<H, C, R, QP><<<grid, kThreads, S::kBytes, stream>>>(
      q, keys, pos0, seq, splits, split_keys, scale_log2, out, part_acc,
      part_ml);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int C, int R>
int launch(const bf16* q, const Keys& keys, const int* pos0, bf16* out,
           float* part_acc, float* part_ml, int batch, int seq, int splits,
           int split_keys, float scale_log2, cudaStream_t stream) {
  if (seq > 1) {
    return launch_tiles<H, C, R, 4>(q, keys, pos0, out, nullptr, nullptr,
                                    batch, seq, 1, keys.kmax, scale_log2,
                                    stream);
  }
  if (splits == 1) {
    return launch_tiles<H, C, R, 1>(q, keys, pos0, out, nullptr, nullptr,
                                    batch, 1, 1, split_keys, scale_log2,
                                    stream);
  }
  const int rc = launch_tiles<H, C, R, 1>(q, keys, pos0, out, part_acc,
                                          part_ml, batch, 1, splits,
                                          split_keys, scale_log2, stream);
  if (rc != 0) return rc;
  latent_split_merge_kernel<H, R><<<dim3(batch, H), kMergeThreads, 0,
                                    stream>>>(
      part_acc, part_ml, pos0, keys.kmax, splits, split_keys, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes); returns cudaGetLastError(), or
// cudaErrorInvalidValue for widths it is not built for. `tables` null: a
// dense cache of `kmax` positions a batch row. The decode (`seq` 1) covers
// its keys in `splits` blocks of `split_keys` (a multiple of 32); the
// prefill ignores both. `part_acc` (B, splits, H, R) and `part_ml` (B,
// splits, H, 2) fp32 are the decode's scratch when `splits` > 1.
extern "C" {

int latent_attention_bf16(const void* q, const void* rows, const void* tables,
                          const void* pos0, void* out, void* part_acc,
                          void* part_ml, int batch, int seq, int heads,
                          int width, int rank, int max_blocks, int block_size,
                          int kmax, int splits, int split_keys,
                          float scale_log2, void* stream) {
  if (seq == 1 && (splits < 1 || splits > kMaxSplits || split_keys < 1 ||
                   split_keys % kKeys != 0 ||
                   static_cast<long long>(splits) * split_keys < kmax))
    return cudaErrorInvalidValue;
  const Keys keys{static_cast<const bf16*>(rows),
                  static_cast<const int*>(tables), max_blocks, block_size,
                  kmax};
  const bf16* qp = static_cast<const bf16*>(q);
  const int* pp = static_cast<const int*>(pos0);
  bf16* op = static_cast<bf16*>(out);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads == 16 && width == 576 && rank == 512) {  // Moonlight-16B-A3B
    return launch<16, 576, 512>(qp, keys, pp, op, acc, ml, batch, seq, splits,
                                split_keys, scale_log2, st);
  }
  if (heads == 4 && width == 48 && rank == 32) {  // the tests' tiny stack
    return launch<4, 48, 32>(qp, keys, pp, op, acc, ml, batch, seq, splits,
                             split_keys, scale_log2, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
