// Unmasked attention forward with an online softmax (FlashAttention style)
// and optional attention-probability dropout, over (bh, S, d) tensors in
// float32 or bfloat16.
//
// Replaces: imagined_speech_translation_tpu/ops/pallas_attention.py:_fwd_kernel
// (called by _fwd_call, _flash_core and flash_attention): the region encoders'
// self-attention (head dim 128 at heads (6,6,6); 96/192 at (8,4,4)) and the
// shared cross-scale attention (head dim 256), all over 1655 tokens.
//
// What bounds it on an H100: arithmetic, 4 * bh * s_q * s_kv * d FLOPs
// against ~4 (bh, S, d) tensors moved: 0.545 ms at both serving shapes,
// (384, 1655, 128) and (192, 1655, 256), and 0.136 ms at both training
// shapes, (96, 1655, 128) and (48, 1655, 256), at the bf16 tensor-core peak
// of 989 TFLOP/s; in float32 3.264 and 0.816 ms at 165 TFLOP/s (3xTF32,
// below).  The (S, S) score matrix never leaves the chip.
//
// Semantics, all variants: scores are scaled by scale * log2(e) in f32
// after the product, keys >= s_kv score -1e30 and padded V rows are zero, as
// in the TPU kernel; the online softmax runs in f32 with exp2f; the output is
// written in the input dtype, rows >= s_q not at all, and the base-2
// logsumexp (m + log2 l) as float32 (bh, s_q) for the backward.
//
// Dropout (training): each probability is replaced by keep ? p / (1 - rate)
// : 0 before it enters P V, while the row sum l (and so lse) keeps the
// undropped p, as the TPU kernel does.  The keep bit of element (bh, row,
// col) comes from dropout_mask.cuh, a hash of the seed and the element's
// place in flash_attention's logical tiles, so the backward kernel
// regenerates the same mask without storing it.  The seed is a kernel
// argument drawn on the host.
//
// Three variants, chosen by what the call can observe:
//
// * bfloat16 with d % 16 == 0 and 16-byte aligned tensors (every serving and
//   training shape): built for Hopper from the helpers of sm90.cuh, 384
//   threads a block.  Against what held the mma.sync kernel it replaces:
//   - wgmma, not mma.sync: S = Q K^T by wgmma with both operands in shared
//     memory (K-major 64-row tiles in TMA's 128-byte swizzle), O += P V by
//     wgmma with P as the register A operand, packed to bf16 in place from
//     the S accumulator (the layouts coincide), and V read MN-major from the
//     same TMA tiles; P never touches shared memory and no operand goes
//     through ldmatrix.  Within a warpgroup S of key tile j runs beside
//     P V of tile j - 1, so the softmax of one tile overlaps the other
//     product;
//   - loads overlap compute: a producer warp loads the block's Q tile once
//     and keeps two rings in flight by TMA, K's and V's (4 stages at d <= 64,
//     3 at 128 and 192, 2 at 256), each stage signalled by an mbarrier with its byte count
//     and released by one arrival of each consumer warp, K's as soon as S is
//     done; no consumer thread spends a register or an instruction on a copy;
//   - bigger key tiles: 128 keys a stage at d <= 128 (S by m64n128k16) and 64
//     at d > 128, where the mma.sync kernel took 32, doubling its tiles,
//     rescales and barriers; setmaxnreg gives the two consumer warpgroups
//     240 registers a thread (O is 128 floats at d = 256, S 64 at d = 128)
//     and the producer 24;
//   - 128 queries a block in two consumer warpgroups of 64 (the mma.sync
//     kernel had 64 in four warps), so each K/V tile is fetched half as
//     often, and while one warpgroup runs its softmax the other's products
//     run (no explicit ping-pong between them);
//   - the dropout mask: where the logical tiles are multiples of the 64-query
//     x 128- (or 64-) key kernel tile, the hash input is computed once per
//     tile (dropout_tile_base) and only the finaliser per element; other
//     logical tiles keep two divisions per element.  Both give the same
//     bits, and they are computed while the S product runs.
//   Tails: TMA fills zeros past S and past d (whole boxes past s_kv
//   included); O is written by guarded stores.  Shared memory: Q 32 KB and
//   3 x 64 KB of K/V stages at d = 128, Q 64 KB and 2 x 64 KB at d = 256.
// * float32 with d % 8 == 0 and 16-byte aligned tensors (every serving,
//   training and eval-mode gradient shape in f32, cli/profile.py --tiny's 24):
//   flash_fwd_tf32_kernel, on the tensor cores in 3xTF32 (tf32.cuh, shared
//   with the split backward).  Its bound is the FLOPs over 165 TFLOP/s, the
//   rate of f32-accurate products by 3xTF32 (495 TFLOP/s TF32 / 3): 3.264 ms
//   at both serving shapes and 0.816 ms at both training shapes.  What held
//   the CUDA-core variant before it back (24.42 ms at (384, 1655, 128), 36.61
//   ms at (192, 1655, 256), on an H100 at 700 W): f32 FMAs peak at 67
//   TFLOP/s; each thread of a 16 x 16 layout fed its FMAs with scalar
//   shared-memory loads; every global load was synchronous, between
//   __syncthreads(); at d > 128 its key tile was 32 keys.  It reached 22.0
//   and 14.7 TFLOP/s, 13% and 9% of the 3xTF32 bound.  What this design does:
//   - S = Q K^T and O += P V by mma.sync m16n8k8 in TF32, each operand split
//     into big and small in registers, three products a step into f32
//     accumulators (one TF32 product alone misses the 1e-4 bound); S is
//     scaled by qscale in f32 after the product;
//   - each warp owns 16 query rows and keeps S, the row max m, its share of
//     the row sum l and O (d / 2 floats a thread) in registers: the online
//     softmax runs in the accumulator layout (row g: columns 2t, 2t + 1; two
//     shuffles reduce a row), and P is fed from the S registers as they lie
//     as the A operand of P V, with the contraction slots permuted and V read
//     MN-major at rows 2t and 2t + 1, so P never touches shared memory;
//   - Q once and K and V by key tile, by cp.async with zeros past s_q and
//     s_kv, rows padded to d + 4 floats, K-major fragments by ldmatrix;
//   - each 64-key tile is split across a pair of warps that share 16 rows,
//     each with its own m, l and O; at the end the pair merges through
//     shared memory in a fixed order (m = max(m0, m1), O and l scaled by
//     2^(m0 - m) and 2^(m1 - m)), so there are no atomics and two launches
//     give the same bits.  d <= 128: 16 warps (128 queries) a block, two
//     stages of 64 keys, whose next copy runs under the current tile
//     (202.8 KB at d = 128); d > 128: 8 warps (64 queries), one 64-key
//     tile (199.7 KB at d = 256), since O takes 128 registers a thread;
//   - dropout: each p (the row sum keeps the undropped one) times keep *
//     inv_keep, the keep bit of (bh, row, col) from dropout_mask.cuh, its
//     hash input hoisted to the warp's 16 x 32 slice where that lies inside
//     one logical tile (dropout_tile_base), else per element.
//   Times of the alternatives, from cli/tune_split_bwd.py --program fwd_tf32
//   on an H100 at 700 W: at (384, 1655, 128) 10.96 ms as dispatched, 12.15
//   with two 32-key stages, 11.80 with one 64-key tile, 12.72 with one
//   128-key tile (which spills), 16.35 with 8 warps an SM; at (192, 1655,
//   256) 16.35 ms as dispatched, 17.16 with two 32-key stages, 17.07 with
//   10 warps, and 15.26 with 12 warps (96 queries, one 32-key tile), which
//   ptxas can only fit in the 168 registers a thread that 12 warps leave by
//   spilling.  ptxas: 103 registers at d <= 64, 127 at d <= 128, 211 at
//   d = 256, no spills.
// * any other d <= 256, in either dtype: a CUDA-core kernel in f32, bounded
//   by the FMA rate and the shared-memory loads feeding it.  One block per
//   (bh, 64-query tile), looping over key tiles of 64 (d <= 128) or 32 (d >
//   128) keys held in dynamic shared memory (up to ~137 KB at d = 256 in
//   f32); 256 threads; Q, K, V and the probability tile in shared memory as
//   float32 (bf16 widened on load); each thread owns a 4 x (BK/16) tile of
//   scores and a 4 x (DMAX/16) tile of the output in registers, q is
//   pre-scaled, and row max/sum are reduced across the 16 threads of a row
//   with warp shuffles.  Q and K rows use a stride of d + 1 floats so that 16
//   threads reading 16 different rows hit 16 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_mask.cuh"
#include "sm90.cuh"
#include "tf32.cuh"


namespace {

using sm90::fence_frags;
using sm90::pack;
using sm90::pack_bf16;
using sm90::zero;

constexpr int kBQ = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int BK>
size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (d + 1) + static_cast<size_t>(BK) * (d + 1) +
          static_cast<size_t>(BK) * d + static_cast<size_t>(kBQ) * (BK + 1));
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s_q, int s_kv, int d,
                     float qscale, DropoutMask drop) {
  constexpr int RPT = kBQ / 16;   // query rows per thread
  constexpr int CPT = BK / 16;    // key columns per thread
  constexpr int DPT = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int pld = BK + 1;
  float* qs = smem;           // kBQ x ld
  float* ks = qs + kBQ * ld;  // BK x ld
  float* vs = ks + BK * ld;   // BK x d
  float* ps = vs + BK * d;    // kBQ x pld

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t kv_base = static_cast<size_t>(bh) * s_kv * d;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int row = q0 + r;
    qs[r * ld + c] =
        row < s_q ? to_f32(q[q_base + static_cast<size_t>(row) * d + c]) * qscale : 0.f;
  }

  float acc[RPT][DPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (s_kv + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V/P are consumed; Q is written
    for (int idx = tid; idx < BK * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx - r * d;
      const int row = k0 + r;
      const bool ok = row < s_kv;
      const size_t g = kv_base + static_cast<size_t>(row) * d + c;
      ks[r * ld + c] = ok ? to_f32(k[g]) : 0.f;
      vs[r * d + c] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < d; ++kk) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * ld + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * ld + kk];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (k0 + tx + 16 * j >= s_kv) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float p = exp2f(s[i][j] - m_new);
        rs += p;  // the normalizer sums the undropped probabilities
        if (drop.on)
          p = dropout_keep(drop, bh, q0 + ty + 16 * i, k0 + tx + 16 * j) ? p * drop.inv_keep
                                                                         : 0.f;
        ps[(ty + 16 * i) * pld + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * pld + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < d ? vs[kk * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_q) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* orow = o + q_base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(orow + col, acc[i][c] * inv);
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * s_q + row] = m[i] + log2f(lc);
  }
}

template <typename T, int DMAX, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<BK>(d);
  auto kernel = flash_fwd_kernel<T, DMAX, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_q + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, s_q, s_kv, d, qscale, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 Hopper version (d a multiple of 16, 16-byte aligned tensors)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;     // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kWgBQ = 128;          // queries per block, 64 per consumer warpgroup
constexpr int kTile = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 tile
constexpr int kConsumerRegs = 240;  // setmaxnreg: 2 x 128 x 240 + 128 x 24 = 65,536 - 1,024
constexpr int kProducerRegs = 24;
constexpr int kLaunchRegs = 168;    // what __launch_bounds__(384, 1) gives every thread

// The tile shape of one head dim: NCB 64-wide column blocks of the head dim,
// BN keys a stage (128 where O and S fit the registers together, else 64),
// and the layout of one block's shared memory, in bytes from a 1024-byte
// aligned base: Q as [warpgroup][column block] tiles of 64 rows, then two
// rings of as many stages, K's and V's, each stage NCB column blocks of BN
// rows (BN / 64 tiles one after the other).
template <int NCB>
struct FwdTiles {
  static constexpr int BN = NCB <= 2 ? 128 : 64;
  static constexpr int q = 0;
  static constexpr int q_bytes = 2 * NCB * kTile;
  static constexpr int cb_bytes = BN * 128;  // one column block of a stage
  static constexpr int stage_bytes = NCB * cb_bytes;
  static constexpr int fit = (232448 - 1024 - 256 - q_bytes) / (2 * stage_bytes);
  static constexpr int stages = fit < 4 ? fit : 4;
  static constexpr int k = q_bytes;
  static constexpr int v = k + stages * stage_bytes;
  static constexpr int bars = v + stages * stage_bytes;
  static constexpr int total = bars + (4 * stages + 1) * 8 + 1024;  // + alignment slack
  static_assert(stages >= 2 && total <= 232448, "shared memory of one block");
};

// The accumulator layout (sm90.cuh): element j of a thread sits at row
// 16 warp + g + 8 row_half(j) and column col(j) of the warpgroup's tile.
__device__ __forceinline__ int row_half(int j) { return (j / 2) % 2; }
__device__ __forceinline__ int col(int j, int t) { return 8 * (j / 4) + 2 * t + j % 2; }

// The keep bits of this thread's BN / 2 score elements (bit j % 32 of word
// j / 32: element j, query row0 + 16 warp + g + 8 row_half(j), key key0 +
// col(j)).  Where the 64 x BN kernel tile lies inside one logical tile the
// hash input is hoisted out of the loop; otherwise each element divides.
template <int BN>
__device__ __forceinline__ void keep_bits(uint32_t (&bits)[BN / 64], const DropoutMask& m,
                                          int bh, int row0, int key0, int warp, int g, int t) {
  const int r = 16 * warp + g;
#pragma unroll
  for (int w = 0; w < BN / 64; ++w) bits[w] = 0;
  if (m.block_q % 64 == 0 && m.block_k % BN == 0) {
    const uint32_t bk = static_cast<uint32_t>(m.block_k);
    const uint32_t base =
        dropout_tile_base(m, bh, row0, key0) + static_cast<uint32_t>(r) * bk + 2 * t;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const uint32_t off = 8 * row_half(j) * bk + 8 * (j / 4) + j % 2;
      bits[j / 32] |= static_cast<uint32_t>(dropout_keep_at(m, base, off)) << (j % 32);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      bits[j / 32] |= static_cast<uint32_t>(
                          dropout_keep(m, bh, row0 + r + 8 * row_half(j), key0 + col(j, t)))
                      << (j % 32);
    }
  }
}

// Starts S = Q K^T for one warpgroup (64 queries x BN keys): Q's K-major
// tiles at qs, K's column blocks at ks.
template <int NCB, int BN>
__device__ __forceinline__ void start_qk(float (&s)[BN / 2], uint32_t qs, uint32_t ks) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = sm90::desc_b128(qs + cb * kTile + 32 * kk);
      const uint64_t b = sm90::desc_b128(ks + cb * BN * 128 + 32 * kk);
      if constexpr (BN == 128) {
        sm90::wgmma_ss_n128<0, 0>(s, a, b, 1);
      } else {
        sm90::wgmma_ss<0, 0>(s, a, b, 1);
      }
    }
}

// Starts O[cb] += P V[cb]: P (64 x BN) in registers, V's MN-major column
// blocks at vs.
template <int NCB, int BN>
__device__ __forceinline__ void start_pv(float (&acc)[NCB][32], const uint32_t (&p)[BN / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks)
      sm90::wgmma_rs<1>(acc[cb], p[ks], sm90::desc_b128(vs + cb * BN * 128 + 2048 * ks), 1);
}

struct RowState {
  float m[2], l[2];
};

// The online-softmax step of one key tile on the scores in s (raw Q K^T):
// scales them by qscale, masks keys >= s_kv, updates the row max m and the
// row sum l (undropped probabilities, this thread's columns only), and
// leaves in s the probabilities to multiply V with (dropped and scaled when
// dropout is on).  Sets the factors alpha that rescale the rows' earlier
// output.
template <int BN>
__device__ __forceinline__ void softmax_step(float (&s)[BN / 2], RowState& rs,
                                             float (&alpha)[2], int key0, int s_kv, int t,
                                             float qscale, const DropoutMask& drop,
                                             const uint32_t (&keep)[BN / 64]) {
  const bool tail = key0 + BN > s_kv;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    float x = s[j] * qscale;
    if (tail && key0 + col(j, t) >= s_kv) x = kNegInf;
    s[j] = x;
    mx[row_half(j)] = fmaxf(mx[row_half(j)], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(rs.m[h], mx[h]);
    alpha[h] = exp2f(rs.m[h] - m_new);
    rs.m[h] = m_new;
    rs.l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const int h = row_half(j);
    float p = exp2f(s[j] - rs.m[h]);
    rs.l[h] += p;  // the normalizer sums the undropped probabilities
    if (drop.on) p = (keep[j / 32] >> (j % 32)) & 1u ? p * drop.inv_keep : 0.f;
    s[j] = p;
  }
}

template <int NCB>
__device__ __forceinline__ void rescale(float (&acc)[NCB][32], const float (&alpha)[2]) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[cb][j] *= alpha[row_half(j)];
}

template <int NCB>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int n_qt,
                           int s_q, int s_kv, int d, float qscale, DropoutMask drop) {
  using L = FwdTiles<NCB>;
  constexpr int BN = L::BN;
  constexpr int kStages = L::stages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  // [0]: K's ring, [1]: V's
  uint64_t* full[2] = {reinterpret_cast<uint64_t*>(smem + L::bars),
                       reinterpret_cast<uint64_t*>(smem + L::bars) + kStages};
  uint64_t* empty[2] = {full[1] + kStages, full[1] + 2 * kStages};
  uint64_t* q_full = empty[1] + kStages;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kWgBQ;
  const int n_kt = (s_kv + BN - 1) / BN;
  const bool two = q0 + 64 < s_q;  // both warpgroups have rows < s_q

  if (threadIdx.x == 0) {
    for (int kv = 0; kv < 2; ++kv)
      for (int s = 0; s < kStages; ++s) {
        sm90::mbar_init(&full[kv][s], 1);   // the producer's byte count
        sm90::mbar_init(&empty[kv][s], 8);  // one arrival per consumer warp
      }
    sm90::mbar_init(q_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread loads Q once and keeps the K and V rings full
    sm90::reg_dealloc<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      sm90::mbar_arrive_expect_tx(q_full, (two ? 2 : 1) * NCB * kTile);
      for (int w = 0; w < (two ? 2 : 1); ++w)
        for (int cb = 0; cb < NCB; ++cb)
          sm90::tma_load_3d(smem + L::q + (w * NCB + cb) * kTile, &tm_q, q_full, 64 * cb,
                            q0 + 64 * w, bh);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        for (int kv = 0; kv < 2; ++kv) {
          sm90::mbar_wait(&empty[kv][s], ((it / kStages) & 1) ^ 1);
          unsigned char* st = smem + (kv ? L::v : L::k) + s * L::stage_bytes;
          sm90::mbar_arrive_expect_tx(&full[kv][s], L::stage_bytes);
          for (int cb = 0; cb < NCB; ++cb)
            for (int r = 0; r < BN / 64; ++r)
              sm90::tma_load_3d(st + cb * L::cb_bytes + r * kTile, kv ? &tm_v : &tm_k,
                                &full[kv][s], 64 * cb, BN * it + 64 * r, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries row0 .. row0 + 63
  sm90::reg_alloc<kConsumerRegs>();
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + 64 * wg;
  const uint32_t qs = sm90::smem_u32(smem + L::q + wg * NCB * kTile);
  const uint32_t k_ring = sm90::smem_u32(smem + L::k);
  const uint32_t v_ring = sm90::smem_u32(smem + L::v);
  auto k_tiles = [&](int it) { return k_ring + (it % kStages) * L::stage_bytes; };
  auto v_tiles = [&](int it) { return v_ring + (it % kStages) * L::stage_bytes; };
  auto wait_tile = [&](int kv, int it) {
    sm90::mbar_wait(&full[kv][it % kStages], (it / kStages) & 1);
  };
  auto release_tile = [&](int kv, int it) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[kv][it % kStages]);
  };
  if (row0 >= s_q) {
    // no query of this warpgroup exists: only pass the stages on
    for (int it = 0; it < n_kt; ++it)
      for (int kv = 0; kv < 2; ++kv) {
        wait_tile(kv, it);
        release_tile(kv, it);
      }
    return;
  }
  sm90::mbar_wait(q_full, 0);

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) zero(acc[cb]);
  RowState rs{{kNegInf, kNegInf}, {0.f, 0.f}};
  float alpha[2];
  float sa[BN / 2];
  uint32_t keep[BN / 64];
#pragma unroll
  for (int w = 0; w < BN / 64; ++w) keep[w] = ~0u;
  uint32_t pf[BN / 16][4];

  // S of tile it runs beside P V of tile it - 1: the softmax of one tile
  // overlaps the other product of this warpgroup
  wait_tile(0, 0);
  zero(sa);
  sm90::fence_regs(sa);
  sm90::wgmma_fence();
  start_qk<NCB, BN>(sa, qs, k_tiles(0));
  sm90::wgmma_commit();
  if (drop.on) keep_bits<BN>(keep, drop, bh, row0, 0, warp, g, t);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sa);
  release_tile(0, 0);
  softmax_step<BN>(sa, rs, alpha, 0, s_kv, t, qscale, drop, keep);
  pack(pf, sa);
  for (int it = 1; it < n_kt; ++it) {
    wait_tile(0, it);
    wait_tile(1, it - 1);
    zero(sa);
    sm90::fence_regs(sa);
    sm90::wgmma_fence();
    start_qk<NCB, BN>(sa, qs, k_tiles(it));
    sm90::wgmma_commit();
    start_pv<NCB, BN>(acc, pf, v_tiles(it - 1));
    sm90::wgmma_commit();
    if (drop.on) keep_bits<BN>(keep, drop, bh, row0, BN * it, warp, g, t);
    sm90::wgmma_wait<1>();  // S of tile it
    sm90::fence_regs(sa);
    release_tile(0, it);
    softmax_step<BN>(sa, rs, alpha, BN * it, s_kv, t, qscale, drop, keep);
    sm90::wgmma_wait<0>();  // P V of tile it - 1
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) sm90::fence_regs(acc[cb]);
    fence_frags(pf);
    release_tile(1, it - 1);
    rescale<NCB>(acc, alpha);
    pack(pf, sa);
  }
  wait_tile(1, n_kt - 1);
  sm90::wgmma_fence();
  start_pv<NCB, BN>(acc, pf, v_tiles(n_kt - 1));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) sm90::fence_regs(acc[cb]);
  fence_frags(pf);
  release_tile(1, n_kt - 1);

  // O = acc / l in bf16 and lse = m + log2 l, rows < s_q only
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = rs.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    const int row = row0 + 16 * warp + g + 8 * h;
    if (row >= s_q) continue;
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * s_q + row) * d;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 64 * cb + 8 * i + 2 * t;
        if (c < d) {
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(acc[cb][4 * i + 2 * h] * inv, acc[cb][4 * i + 2 * h + 1] * inv);
        }
      }
    if (t == 0) lse[static_cast<size_t>(bh) * s_q + row] = rs.m[h] + log2f(lc);
  }
}

template <int NCB>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                 int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
                 cudaStream_t stream) {
  using L = FwdTiles<NCB>;
  auto kernel = flash_fwd_wgmma_kernel<NCB>;
  const long long n_qt = (s_q + kWgBQ - 1) / kWgBQ;
  if (n_qt * bh > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // setmaxnreg moves registers between the warpgroups of a fixed pool: it
  // needs the launch to hold kLaunchRegs a thread, or the consumers would wait forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != kLaunchRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_q, tm_k, tm_v;
  int map_err = sm90::make_tile_map(&tm_q, q, bh, s_q, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_k, k, bh, s_kv, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_v, v, bh, s_kv, d);
  if (map_err) return map_err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_qt * bh), kWgThreads, L::total, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, static_cast<int>(n_qt), s_q,
      s_kv, d, qscale, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores in 3xTF32 (d a multiple of 8, 16-byte aligned)
// ---------------------------------------------------------------------------

// Shared memory: Q (16 NR rows), then STAGES stages of a key tile's K and V
// (BK rows each), rows of d + 4 floats; at the end the same space holds the
// second key half's partial output, row max and row sum for the merge.
template <int NR, int BK, int STAGES>
size_t fwd_tf32_smem_bytes(int d) {
  const size_t tiles = static_cast<size_t>(16 * NR + 2 * STAGES * BK) * (d + 4);
  const size_t merge = static_cast<size_t>(NR) * 32 * (d / 2 + 4);
  return sizeof(float) * (tiles > merge ? tiles : merge);
}

// The online-softmax step of one warp's key slice on its scores s (raw Q K^T
// of 16 rows x 8 NS keys from key0, accumulator layout: element e of n-tile n
// at row g + 8 (e / 2), key key0 + 8 n + 2 t + e % 2): scales them by
// qscale, scores keys >= s_kv -1e30, updates the row max m and this thread's
// share of the row sum l (undropped probabilities), and leaves in s the
// probabilities to multiply V with (dropped and scaled when dropout is on).
// Sets alpha, the factors that rescale the rows' earlier output.  The caller
// runs it only where key0 < s_kv, so every row max is finite.
template <int NS>
__device__ __forceinline__ void softmax_tf32(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int key0, int s_kv,
                                             float qscale, const DropoutMask& drop, bool hoist,
                                             int bh, int row0, int g, int t) {
  const bool tail = key0 + 8 * NS > s_kv;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * qscale;
      if (tail && key0 + 8 * n + 2 * t + (e & 1) >= s_kv) x = kNegInf;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
  // the keep bits: where the warp's 16 x 8 NS tile lies inside one logical
  // tile, the hash input hoisted to the tile (dropout_tile_base), else per
  // element; both give dropout_keep's bits
  uint32_t base = 0;
  if (drop.on && hoist)
    base = dropout_tile_base(drop, bh, row0, key0) +
           static_cast<uint32_t>(g) * static_cast<uint32_t>(drop.block_k) + 2 * t;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = exp2f(s[n][e] - m[h]);
      l[h] += p;  // the normalizer sums the undropped probabilities
      if (drop.on) {
        const bool keep =
            hoist ? dropout_keep_at(drop, base,
                                    8 * h * static_cast<uint32_t>(drop.block_k) + 8 * n + (e & 1))
                  : dropout_keep(drop, bh, row0 + g + 8 * h, key0 + 8 * n + 2 * t + (e & 1));
        p = keep ? p * drop.inv_keep : 0.f;
      }
      s[n][e] = p;
    }
}

// One block per (bh, tile of 16 NR queries), 2 NR warps: warps w and w + NR
// own query rows 16w .. 16w + 15, w the first half of each key tile and
// w + NR the second, each with its own row max, row sum and output in
// registers for the whole key loop.  At the end w + NR hands its state to w
// through shared memory and w merges the two, in that order, and writes the
// rows.  Per key slice: S = Q K^T (scores_3xtf32, both K-major by ldmatrix),
// the online softmax in the accumulator layout, O += P V (grads_3xtf32, P
// fed from the S registers as they lie, V read MN-major at rows 2t, 2t + 1).
template <int DMAX, int NR, int BK, int STAGES>
__global__ void __launch_bounds__(64 * NR, 1)
    flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int n_qt, int s_q, int s_kv, int d,
                          float qscale, DropoutMask drop) {
  constexpr int NT = 64 * NR;
  constexpr int BQ = 16 * NR;
  constexpr int NS = BK / 16;   // score n-tiles of 8 keys a warp
  constexpr int NO = DMAX / 8;  // output n-tiles of 8 dims
  extern __shared__ __align__(16) float smem_f[];
  const int ld = d + 4;
  float* qs = smem_f;
  float* kv_tiles = qs + BQ * ld;  // [stage]: K then V of a key tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp % NR;
  const int wrow = 16 * rg;
  const int wkey = (warp / NR) * (BK / 2);
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * BQ;
  const float* kb = k + static_cast<size_t>(bh) * s_kv * d;
  const float* vb = v + static_cast<size_t>(bh) * s_kv * d;

  load_rows<BQ, NT>(qs, q + static_cast<size_t>(bh) * s_q * d, q0, s_q, d, ld);
  auto load_tile = [&](int kt, int stage) {
    float* dst = kv_tiles + stage * 2 * BK * ld;
    load_rows<BK, NT>(dst, kb, kt, s_kv, d, ld);
    load_rows<BK, NT>(dst + BK * ld, vb, kt, s_kv, d, ld);
  };
  load_tile(0, 0);
  cp_async_commit();

  // a warp's 16 x BK / 2 slice lies inside one logical dropout tile
  const bool hoist = drop.block_q % 16 == 0 && drop.block_k % (BK / 2) == 0;
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0, kt = 0; kt < s_kv; ++it, kt += BK) {
    if (STAGES == 1 && it > 0) {
      __syncthreads();  // every warp is done with the previous key tile
      load_tile(kt, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // this key tile has landed (and, two stages, the last is done)
    if (STAGES == 2 && kt + BK < s_kv) {
      load_tile(kt + BK, (it + 1) % 2);
      cp_async_commit();
    }
    const int k0 = kt + wkey;
    if (k0 >= s_kv) continue;  // this warp's half lies past the last key
    const float* ks = kv_tiles + (it % STAGES) * 2 * BK * ld + wkey * ld;
    const float* vs = ks + BK * ld;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    scores_3xtf32<NS>(s, qs + wrow * ld, ks, ld, d, lane);  // S = Q K^T
    float alpha[2];
    softmax_tf32<NS>(s, m, l, alpha, k0, s_kv, qscale, drop, hoist, bh, q0 + wrow, g, t);
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= alpha[0];
      acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1];
      acc[c][3] *= alpha[1];
    }
    grads_3xtf32<NS, NO>(acc, s, vs, ld, d, g, t);  // O += P V
  }

  // row sums over the four lanes of a row, then the second key half's state
  // to the first, through the tiles' space
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int no = d / 8;
  float* part = smem_f + rg * 32 * (4 * no + 4);
  __syncthreads();  // every warp is done with Q and the last tiles
  if (warp >= NR) {
#pragma unroll
    for (int c = 0; c < NO; ++c)
      if (c < no)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(c * 4 + e) * 32 + lane] = acc[c][e];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[(4 * no + h) * 32 + lane] = m[h];
      part[(4 * no + 2 + h) * 32 + lane] = l[h];
    }
  }
  __syncthreads();
  if (warp >= NR) return;
  float a0[2], a1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = part[(4 * no + h) * 32 + lane];
    const float mm = fmaxf(m[h], m1);
    a0[h] = exp2f(m[h] - mm);
    a1[h] = exp2f(m1 - mm);
    l[h] = l[h] * a0[h] + part[(4 * no + 2 + h) * 32 + lane] * a1[h];
    m[h] = mm;
  }
  // O = (O0 a0 + O1 a1) / l, lse = m + log2 l, rows < s_q only
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / lc;
    const int row = q0 + wrow + g + 8 * h;
    if (t == 0 && row < s_q) lse[static_cast<size_t>(bh) * s_q + row] = m[h] + log2f(lc);
  }
#pragma unroll
  for (int c = 0; c < NO; ++c)
    if (c < no)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[c][e] = (acc[c][e] * a0[e >> 1] + part[(c * 4 + e) * 32 + lane] * a1[e >> 1]) *
                    inv[e >> 1];
  store_frag_rows<NO>(o + static_cast<size_t>(bh) * s_q * d, acc, q0 + wrow, s_q, d, g, t, 1.f);
}

template <int DMAX, int NR, int BK, int STAGES>
int launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
                cudaStream_t stream) {
  const long long n_qt = (s_q + 16 * NR - 1) / (16 * NR);
  if (n_qt * bh > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_tf32_smem_bytes<NR, BK, STAGES>(d);
  auto kernel = flash_fwd_tf32_kernel<DMAX, NR, BK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_qt * bh), 64 * NR, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, static_cast<int>(n_qt), s_q, s_kv, d, qscale, drop);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int bh, int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
             cudaStream_t st) {
  if (d <= 64) return launch<T, 64, 64>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 128) return launch<T, 128, 64>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  return launch<T, 256, 32>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
}

// float32 takes the 3xTF32 kernel where d % 8 == 0 and every tensor is
// 16-byte aligned (cp.async copies 16 bytes), else the CUDA-core one.
int dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                 int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
                 cudaStream_t st) {
  if (d % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return dispatch<float>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 64)
    return launch_tf32<64, 8, 64, 2>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 128)
    return launch_tf32<128, 8, 64, 2>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  return launch_tf32<256, 4, 64, 1>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
                  cudaStream_t st) {
  if (d % 16 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 64) return launch_wgmma<1>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 128) return launch_wgmma<2>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 192) return launch_wgmma<3>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  return launch_wgmma<4>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
}

}  // namespace

extern "C" {

// q: (bh, s_q, d); k, v: (bh, s_kv, d); o: (bh, s_q, d), all contiguous on the
// device in one dtype (0 = float32, 1 = bfloat16).  lse: float32 (bh, s_q).
// qscale = softmax scale * log2(e).  Dropout: dropout != 0 applies the keep
// mask of dropout_mask.cuh for (seed, threshold, block_q, block_k) and scales
// kept probabilities by inv_keep.  Returns the cudaError_t of the launch.
int ist_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                  int bh, int s_q, int s_kv, int d, float qscale, int dtype, int dropout,
                  int seed, unsigned threshold, int block_q, int block_k, float inv_keep,
                  void* stream) {
  if (bh < 1 || s_q < 1 || s_kv < 1 || d < 1 || d > 256 ||
      (s_q + kBQ - 1) / kBQ > 65535 || (dropout && (block_q < 1 || block_k < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutMask drop = make_dropout_mask(dropout, seed, threshold, block_q, block_k, inv_keep);
  if (dtype == 0) return dispatch_f32(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (dtype == 1) return dispatch_bf16(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
