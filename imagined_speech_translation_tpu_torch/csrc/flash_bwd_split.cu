// Split attention backward without dropout: one kernel for dQ, one for dK and
// dV, over (bh, S, d) tensors in float32 or bfloat16.
//
// Replaces: imagined_speech_translation_tpu/ops/pallas_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (called by _bwd_call_split from
// _flash_core_bwd, which sends every backward at dropout rate 0 to them): the
// gradient of the eval-mode model, as cli/profile.py --what train takes it,
// at (B*4*6, 1655, 128) for the region encoders' self-attention and
// (B*4*3, 1655, 256) for the shared cross-scale attention, in float32.
//
// Given the forward's inputs, its base-2 logsumexp lse and delta =
// rowsum(dO * O) (computed by the caller in float32), both kernels recompute
// P = exp2(S * scale * log2 e - lse) and dS = P * (dO V^T - delta):
//
//   dQ  = scale * dS K                          (ist_flash_bwd_dq)
//   dV  = P^T dO,  dK = scale * dS^T Q          (ist_flash_bwd_dkv)
//
// What bounds them on an H100: arithmetic, 6 and 8 * bh * s_q * s_kv * d
// FLOPs (the TPU cost estimates), against ~5 and ~6 tensors of (bh, S, d)
// moved.  S and dP are computed by both kernels, so the pair does 14 against
// the fused kernel's 10; in exchange nothing is shared between blocks.  In
// float32 the least time is the FLOPs over 165 TFLOP/s, the rate at which the
// tensor cores give f32-accurate products by 3xTF32 (495 TFLOP/s TF32 / 3):
// 5.71 ms for the pair at (192, 1655, 128) and at (96, 1655, 256).
//
// Design.  On the TPU the dQ kernel keeps the whole key range in VMEM (one
// key block at rate 0) and the dK/dV kernel revisits its output block across
// a sequential query axis.  Blocks on the card run in parallel and in no
// order, so each block owns its output tile and loops over the other axis
// inside the block: the dQ kernel one (bh, query tile) looping over key
// tiles, the dK/dV kernel one (bh, key tile) looping over query tiles.  No
// block writes another block's output and no sum depends on timing, so two
// launches on the same inputs give the same bits.
//
// Tails: key columns >= s_kv score -1e30 (P = 0) against zero K/V rows;
// query rows >= s_q read no lse or delta and contribute nothing.  Rounding:
// every sum is float32; dS (and, for dV, P) is rounded to the input dtype
// before its product, as the TPU kernels round it; dQ, dK and dV are written
// in the input dtype.  The TPU kernels pre-scale Q in the input dtype before
// S and dK; these kernels scale the float32 products instead, so in bfloat16
// they skip one rounding of Q (a relative 2^-9 per element of Q, below the
// bf16 rounding of dS itself).
//
// Variants, chosen by what the call can observe:
//
// * float32 with d % 8 == 0 and 16-byte aligned tensors (the eval-mode
//   gradient's d = 128 and 256, cli/profile.py --tiny's 24): the tensor cores
//   in 3xTF32, flash_bwd_dq_tf32_kernel and flash_bwd_tf32_kernel.  What
//   held the CUDA-core kernels before them back (23.3 + 27.5 ms at d = 128,
//   61.7 + 46.6 ms at d = 256, on an H100 at 700 W): f32 FMAs peak at 67
//   TFLOP/s; each thread of a 16 x 16 layout issued 16 shared loads per 32
//   FMAs at d <= 128 and 8 per 8 at d = 256 (32 x 32 tiles), so they reached
//   26% and 10% of that peak; every global load was synchronous, between
//   __syncthreads().  What this design does:
//   - mma.sync m16n8k8 in TF32 with f32 accumulators.  Each operand x is
//     split in registers, as its fragment is loaded, into big = x cut toward
//     zero to TF32 and small = x - big (cut in turn); a product is a_small
//     b_big + a_big b_small, then a_big b_big, into the same f32
//     accumulator.  The dropped a_small b_small is below 2^-20 |a b| and the
//     cut small below 2^-20 |x|, so the gradients keep f32 accuracy (one
//     TF32 product alone misses the 1e-4 bound by 4-9x).  The cut happens
//     in the tensor cores, so a split takes two operations.  Shared memory
//     holds each tile once, in f32.
//   - S (or S^T) and dP are computed into registers, dS formed there and fed
//     straight back as the A operand of the next product.  The tf32 C
//     fragment (row g: columns 2t, 2t + 1) is not the A fragment (row g:
//     columns t, t + 4), so the 8-wide contraction slice is permuted: k index
//     t takes element 2t and t + 4 takes 2t + 1, and B is read at rows 2t and
//     2t + 1 to match.  A sum does not depend on the order of its terms'
//     slots, so nothing moves between lanes.
//   - K-major fragments (A always; B of S and dP) come by ldmatrix, which
//     reads 8 rows of 16 bytes a matrix: an 8 x 4 block of floats, lane
//     (g, t) receiving element (g, t), the tf32 fragment's layout.  The
//     MN-major B of the gradient products (rows 2t and 2t + 1, column g)
//     takes scalar loads.  Rows padded to d + 4 floats (d % 8 == 0, so the
//     stride is 4 mod 8 words): ldmatrix's 8 rows fall in 8 distinct 16-byte
//     bank groups, and the scalar loads of a warp in 32 distinct banks.
//   - The streamed operand (K/V in the dQ kernel, Q/dO with lse/delta in the
//     dK/dV kernel) is copied by cp.async (16 bytes a copy, zeros past the
//     last row).  Shared memory buys either a second stage, whose copy runs
//     while the tile before it is computed, or a wider tile, which splits
//     each A fragment once for more products; the card chose per kernel.
//   - Warps and instructions: mma.sync in TF32 runs at 298-319 TFLOP/s on
//     the card (about 105 of f32-accurate work in 3xTF32), and every product
//     here also needs its fragments loaded and split, so the kernels need
//     many warps to hide latency and few instructions a product: the split
//     takes x itself as big (two operations, not three), and each warp's
//     fragments serve as many products as its registers allow.
//   - Times of the alternatives, from cli/tune_split_bwd.py on an H100 at
//     700 W: dQ at d = 128 8.29 ms as dispatched, 8.68 with one stage, 11.25
//     with 8 warps an SM; dK/dV at d = 128 10.86 ms, 11.97 with 16-query
//     tiles, 15.99 at one block an SM; at d = 256 dK/dV 14.79 ms, 16.94 with
//     16-query tiles.
//   - dQ kernel: 16 query rows per pair of warps, each warp of the pair
//     taking half of every key tile with its own partial dQ in registers for
//     the whole key loop; the partials are added at the end, in a fixed
//     order.  d <= 128: 16 warps (128 queries) at 128 registers a thread,
//     two stages of 32-key tiles, 202.8 KB of shared memory at d = 128 (one
//     64-key tile at d <= 64); d > 128: 8 warps (64 queries), one 32-key
//     tile, 195.0 KB at d = 256.
//   - dK/dV kernel: flash_bwd_tf32_kernel of flash_bwd_tf32.cuh without
//     its dQ and its mask, the template the fused f32 backward shares.
//     S^T = K Q^T and dP^T = V dO^T with 16 keys a warp as M, so P^T and
//     dS^T are the A operands of dV += P^T dO and dK += dS^T Q.  A block
//     holds 64 keys; warps w and w + 4 share 16 of them: w computes S^T, P^T
//     and dV and hands P^T over through shared memory (a named barrier of
//     the pair), w + 4 computes dP^T, dS^T and dK.  One sum a warp stays in
//     registers, so at d <= 128 two blocks of 8 warps fit an SM (107.3 KB
//     each at d = 128); at d = 256 one (203.3 KB).  32-query tiles.
// * bfloat16 with d % 16 == 0 and 16-byte aligned tensors: dQ by
//   flash_bwd_dq_wgmma_kernel, built for Hopper from the helpers of sm90.cuh
//   on the skeleton of flash_fwd.cu's bf16 kernel, 384 threads a block; its
//   bound at (192, 1655, 128) and (96, 1655, 256) is 0.408 ms (6 bh s^2 d
//   FLOPs at 989 TFLOP/s).  What held the mma.sync kernel before it back
//   (3.43 ms at both shapes, on an H100 at 700 W, 12% of the bound): four
//   warps of 16 queries, each K/V tile fetched once per 64 queries by
//   synchronous loads between two __syncthreads(), so no copy overlapped a
//   product.  What this design does:
//   - two consumer warpgroups of 64 queries and a producer warp: 128 queries
//     a block, so each K/V tile is fetched half as often; setmaxnreg gives
//     the consumers 240 registers a thread and the producer 24;
//   - the producer loads the block's Q and dO once and keeps K's and V's
//     rings full by TMA (64-key stages of 64 x 64 tiles in the 128-byte
//     swizzle, each signalled by an mbarrier with its byte count; zeros past
//     s_q, s_kv and d).  The rings release apart: V's stage once dP is done,
//     K's only after the dQ product that reads it;
//   - per key tile S = Q K^T and dP = dO V^T by wgmma from shared memory (both
//     K-major), P = exp2(S qscale - lse) and dS = P (dP - delta) in the
//     registers of S (keys >= s_kv score -inf), dS packed to bf16 in place as
//     the register A operand (the accumulator and A layouts coincide), and
//     dQ += dS K by wgmma with K read MN-major from the same stage: the
//     forward's P V with K in place of V.  dQ stays in registers (d / 2
//     floats a thread) for the whole key loop; lse and delta come into
//     registers once;
//   - at d <= 192, S and dP of key tile j run beside the dQ product of tile
//     j - 1 (two K stages live), so the dS step of one tile overlaps the
//     other product; at d = 256, where dQ is 128 floats a thread, that
//     schedule spills (372 bytes) and the products of a tile run in turn,
//     the other warpgroup filling the gaps.  Shared memory: Q and dO 32 KB
//     each and 3 + 3 stages of 16 KB at d = 128 (160 KB); Q and dO 64 KB
//     each, 2 K stages and 1 V stage of 32 KB at d = 256 (224 KB).
//   Times of the alternatives, from cli/tune_split_bwd.py --program dq_bf16
//   on an H100 at 700 W: at (192, 1655, 128) 0.754 ms as dispatched, 0.750
//   with 4 + 4 stages, 0.755 with 4 + 2, 0.968 with 2 + 2, 0.811 in turn,
//   0.899 with 64 queries a block; at (96, 1655, 256) 0.743 ms as
//   dispatched, 1.087 overlapped (spilling), 0.851 with 1 + 1 stages, 0.759
//   with 64 queries a block and 2 + 2 stages in turn, 0.886 overlapped with
//   3 + 2.  dK/dV: the key-tile backward of flash_bwd_kv.cuh without its dQ
//   reductions, in its Hopper variant.
// * any other d <= 256, in either dtype: CUDA cores in f32.  256 threads as
//   16 x 16; Q, dO, K, V and dS tiles in shared memory as float32 with rows
//   padded by one float; each thread keeps a slice of dQ in registers.
//   Tiles of 64 queries x 64 keys at d <= 128 and 32 x 32 at d = 256 (149
//   and 136 KB).  dK/dV: the CUDA-core key-tile backward of flash_bwd_kv.cuh.

#include "flash_bwd_kv.cuh"
#include "flash_bwd_tf32.cuh"
#include "tf32.cuh"

namespace {

// dS of one score element; zero outside the valid rows.
__device__ __forceinline__ float score_ds(float s, float dp, float lse, float delta, int row,
                                          int col, int s_q, int s_kv, float qscale) {
  if (row >= s_q) return 0.f;
  return exp2f((col < s_kv ? s * qscale : kNegInf) - lse) * (dp - delta);
}

// ---------------------------------------------------------------------------
// dQ, CUDA-core version
// ---------------------------------------------------------------------------

template <int BQ, int BK>
size_t dq_smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(2 * BQ + 2 * BK) * (d + 1) +
                          static_cast<size_t>(BQ) * (BK + 1) + 2 * BQ);
}

template <typename T, int DMAX, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int s_q, int s_kv, int d, float qscale,
                        float scale) {
  constexpr int RPT = BQ / 16;    // query rows per thread
  constexpr int KPT = BK / 16;    // score columns per thread
  constexpr int DPT = DMAX / 16;  // head dims per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int pld = BK + 1;
  float* qs = smem;            // BQ x ld
  float* dos = qs + BQ * ld;   // BQ x ld
  float* ks = dos + BQ * ld;   // BK x ld
  float* vs = ks + BK * ld;    // BK x ld
  float* dss = vs + BK * ld;   // BQ x pld: dS
  float* lse_s = dss + BQ * pld;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t kv_base = static_cast<size_t>(bh) * s_kv * d;
  const T zero = T(0.f);

  for (int idx = tid; idx < BQ * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const bool ok = q0 + r < s_q;
    const size_t gi = q_base + static_cast<size_t>(q0 + r) * d + c;
    qs[r * ld + c] = to_f32(ok ? q[gi] : zero);
    dos[r * ld + c] = to_f32(ok ? dout[gi] : zero);
  }
  for (int r = tid; r < BQ; r += kThreads) {
    const bool ok = q0 + r < s_q;
    lse_s[r] = ok ? lse[static_cast<size_t>(bh) * s_q + q0 + r] : 0.f;
    delta_s[r] = ok ? delta[static_cast<size_t>(bh) * s_q + q0 + r] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < s_kv; k0 += BK) {
    __syncthreads();  // the previous key tile is consumed; Q/dO are written
    for (int idx = tid; idx < BK * d; idx += kThreads) {
      const int r = idx / d;
      const int c = idx - r * d;
      const bool ok = k0 + r < s_kv;
      const size_t gi = kv_base + static_cast<size_t>(k0 + r) * d + c;
      ks[r * ld + c] = to_f32(ok ? k[gi] : zero);
      vs[r * ld + c] = to_f32(ok ? v[gi] : zero);
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows ty + 16 i, columns tx + 16 j
    float s[RPT][KPT], dp[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < d; ++kk) {
      float qv[RPT], dov[RPT], kv[KPT], vv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = qs[(ty + 16 * i) * ld + kk];
        dov[i] = dos[(ty + 16 * i) * ld + kk];
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        kv[j] = ks[(tx + 16 * j) * ld + kk];
        vv[j] = vs[(tx + 16 * j) * ld + kk];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int c = tx + 16 * j;
        const float ds =
            score_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r], q0 + r, k0 + c, s_q, s_kv, qscale);
        dss[r * pld + c] = round_to(ds, zero);
      }
    }
    __syncthreads();

    // dQ += dS K for query rows ty + 16 i, dims tx + 16 c
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dss[(ty + 16 * i) * pld + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < d ? ks[kk * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_q) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(dq + q_base + static_cast<size_t>(row) * d + col, scale * acc[i][c]);
    }
  }
}

template <typename T, int DMAX, int BQ, int BK>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int s_q, int s_kv, int d, float qscale,
              float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<BQ, BK>(d);
  auto kernel = flash_bwd_dq_kernel<T, DMAX, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_q + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), s_q, s_kv, d, qscale,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dQ, bf16 Hopper version (d a multiple of 16, 16-byte aligned tensors)
// ---------------------------------------------------------------------------

constexpr int kDqConsumerRegs = 240;  // setmaxnreg: 2 x 128 x 240 + 128 x 24 = 65,536 - 1,024
constexpr int kDqProducerRegs = 24;

// The layout of one block's shared memory, in bytes from a 1024-byte aligned
// base: Q, then dO, each as [warpgroup][column block] 64 x 64 tiles; K's ring
// of KST stages and V's ring of VST stages, each stage NCB column blocks of
// 64 keys; then the mbarriers.
template <int NCB, int NWG, int KST, int VST>
struct DqTiles {
  static constexpr int rows_bytes = NWG * NCB * kTile;  // Q (or dO) of the block
  static constexpr int q = 0;
  static constexpr int dout = rows_bytes;
  static constexpr int stage_bytes = NCB * kTile;
  static constexpr int k = 2 * rows_bytes;
  static constexpr int v = k + KST * stage_bytes;
  static constexpr int bars = v + VST * stage_bytes;
  static constexpr int total = bars + (2 * (KST + VST) + 1) * 8 + 1024;  // + alignment slack
  static_assert(total <= 232448, "shared memory of one block");
};

// dS of one warpgroup's 64 queries x 64 keys (key0 ..), in place of S: P =
// exp2(S qscale - lse), keys >= s_kv scoring -inf, times dP - delta.  Element
// j of the accumulator layout (sm90.cuh) is row half (j / 2) % 2, key
// key0 + 8 (j / 4) + 2 t + j % 2.
__device__ __forceinline__ void ds_tile(float (&s)[32], const float (&dp)[32],
                                        const float (&lse)[2], const float (&delta)[2],
                                        int key0, int s_kv, int t, float qscale) {
  const bool tail = key0 + 64 > s_kv;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int h = (j / 2) % 2;
    float x = s[j] * qscale;
    if (tail && key0 + 8 * (j / 4) + 2 * t + j % 2 >= s_kv) x = kNegInf;
    s[j] = exp2f(x - lse[h]) * (dp[j] - delta[h]);
  }
}

// Starts S = Q K^T into s and dP = dO V^T into dp for one warpgroup (64
// queries x 64 keys), committed as one group: Q's and dO's K-major tiles at
// qs and dos, the stage's K and V tiles at ks and vs.
template <int NCB>
__device__ __forceinline__ void start_scores(float (&s)[32], float (&dp)[32], uint32_t qs,
                                             uint32_t dos, uint32_t ks, uint32_t vs) {
  zero(s);
  zero(dp);
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
  sm90::wgmma_fence();
  gemm_kmajor<NCB>(s, qs, kTile, ks);
  gemm_kmajor<NCB>(dp, dos, kTile, vs);
  sm90::wgmma_commit();
}

// Holds dQ and the dS operand live until the dQ product that owns them has completed.
template <int NCB>
__device__ __forceinline__ void fence_dq(float (&acc)[NCB][32], uint32_t (&ds)[4][4]) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) sm90::fence_regs(acc[cb]);
  fence_frags(ds);
}

// One block: NWG consumer warpgroups of 64 queries each, and a producer
// warpgroup whose one thread loads the block's Q and dO once and keeps the K
// and V rings full by TMA.  Per 64-key tile each consumer warpgroup computes
// S = Q K^T and dP = dO V^T by wgmma from shared memory, forms dS in the
// registers of S and adds dS K into dQ by wgmma with dS as the register A
// operand and K read MN-major from the same stage.  V's stage is released
// once dP is done, K's once the dQ product is.  kOverlap: S and dP of tile it
// run beside the dQ product of tile it - 1 (KST >= 2), so the dS step of one
// tile overlaps the other product; otherwise each tile's products run in turn.
template <int NCB, int NWG, int KST, int VST, bool kOverlap>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int n_qt, int s_q, int s_kv, int d,
                              float qscale, float scale) {
  static_assert(!kOverlap || KST >= 2, "the overlapped schedule holds two K stages");
  using L = DqTiles<NCB, NWG, KST, VST>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_empty = k_full + KST;
  uint64_t* v_full = k_empty + KST;
  uint64_t* v_empty = v_full + VST;
  uint64_t* rows_full = v_empty + VST;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * 64 * NWG;
  const int n_kt = (s_kv + 63) / 64;
  const int n_wg = min(NWG, (s_q - q0 + 63) / 64);  // warpgroups with rows < s_q

  if (threadIdx.x == 0) {
    for (int s = 0; s < KST; ++s) {
      sm90::mbar_init(&k_full[s], 1);           // the producer's byte count
      sm90::mbar_init(&k_empty[s], 4 * NWG);    // one arrival per consumer warp
    }
    for (int s = 0; s < VST; ++s) {
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&v_empty[s], 4 * NWG);
    }
    sm90::mbar_init(rows_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: Q and dO once; V's ring before K's, whose stages free later
    if constexpr (NWG == 2) sm90::reg_dealloc<kDqProducerRegs>();
    if (warp == 0 && lane == 0) {
      sm90::mbar_arrive_expect_tx(rows_full, 2 * n_wg * NCB * kTile);
      for (int w = 0; w < n_wg; ++w)
        for (int cb = 0; cb < NCB; ++cb) {
          const int off = (w * NCB + cb) * kTile;
          sm90::tma_load_3d(smem + L::q + off, &tm_q, rows_full, 64 * cb, q0 + 64 * w, bh);
          sm90::tma_load_3d(smem + L::dout + off, &tm_do, rows_full, 64 * cb, q0 + 64 * w, bh);
        }
      for (int it = 0; it < n_kt; ++it) {
        const int sv = it % VST;
        sm90::mbar_wait(&v_empty[sv], ((it / VST) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&v_full[sv], L::stage_bytes);
        for (int cb = 0; cb < NCB; ++cb)
          sm90::tma_load_3d(smem + L::v + sv * L::stage_bytes + cb * kTile, &tm_v, &v_full[sv],
                            64 * cb, 64 * it, bh);
        const int sk = it % KST;
        sm90::mbar_wait(&k_empty[sk], ((it / KST) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&k_full[sk], L::stage_bytes);
        for (int cb = 0; cb < NCB; ++cb)
          sm90::tma_load_3d(smem + L::k + sk * L::stage_bytes + cb * kTile, &tm_k, &k_full[sk],
                            64 * cb, 64 * it, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries row0 .. row0 + 63
  if constexpr (NWG == 2) sm90::reg_alloc<kDqConsumerRegs>();
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + 64 * wg;
  const uint32_t k_ring = sm90::smem_u32(smem + L::k);
  const uint32_t v_ring = sm90::smem_u32(smem + L::v);
  auto k_tiles = [&](int it) { return k_ring + (it % KST) * L::stage_bytes; };
  auto v_tiles = [&](int it) { return v_ring + (it % VST) * L::stage_bytes; };
  auto wait_k = [&](int it) { sm90::mbar_wait(&k_full[it % KST], (it / KST) & 1); };
  auto wait_v = [&](int it) { sm90::mbar_wait(&v_full[it % VST], (it / VST) & 1); };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  auto release_k = [&](int it) { release(&k_empty[it % KST]); };
  auto release_v = [&](int it) { release(&v_empty[it % VST]); };
  if (row0 >= s_q) {
    // no query of this warpgroup exists: only pass the stages on
    for (int it = 0; it < n_kt; ++it) {
      wait_v(it);
      release_v(it);
      wait_k(it);
      release_k(it);
    }
    return;
  }
  // this thread's rows row0 + 16 warp + g (+ 8): lse and delta once, none past s_q
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 16 * warp + g + 8 * h;
    const bool ok = row < s_q;
    lse_r[h] = ok ? lse[static_cast<size_t>(bh) * s_q + row] : 0.f;
    delta_r[h] = ok ? delta[static_cast<size_t>(bh) * s_q + row] : 0.f;
  }
  const uint32_t qs = sm90::smem_u32(smem + L::q + wg * NCB * kTile);
  const uint32_t dos = sm90::smem_u32(smem + L::dout + wg * NCB * kTile);
  sm90::mbar_wait(rows_full, 0);

  float acc[NCB][32];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) zero(acc[cb]);
  float sa[32], dpa[32];
  uint32_t dsf[4][4];
  if constexpr (kOverlap) {
    wait_v(0);
    wait_k(0);
    start_scores<NCB>(sa, dpa, qs, dos, k_tiles(0), v_tiles(0));
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sa);
    sm90::fence_regs(dpa);
    release_v(0);
    ds_tile(sa, dpa, lse_r, delta_r, 0, s_kv, t, qscale);
    pack(dsf, sa);
    for (int it = 1; it < n_kt; ++it) {
      wait_v(it);
      wait_k(it);
      start_scores<NCB>(sa, dpa, qs, dos, k_tiles(it), v_tiles(it));
      gemm_rs<NCB>(acc, dsf, k_tiles(it - 1));  // dQ += dS K of tile it - 1
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S and dP of tile it
      sm90::fence_regs(sa);
      sm90::fence_regs(dpa);
      release_v(it);
      ds_tile(sa, dpa, lse_r, delta_r, 64 * it, s_kv, t, qscale);
      sm90::wgmma_wait<0>();  // the dQ product of tile it - 1
      fence_dq<NCB>(acc, dsf);
      release_k(it - 1);
      pack(dsf, sa);
    }
    sm90::wgmma_fence();
    gemm_rs<NCB>(acc, dsf, k_tiles(n_kt - 1));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_dq<NCB>(acc, dsf);
    release_k(n_kt - 1);
  } else {
    for (int it = 0; it < n_kt; ++it) {
      wait_v(it);
      wait_k(it);
      start_scores<NCB>(sa, dpa, qs, dos, k_tiles(it), v_tiles(it));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sa);
      sm90::fence_regs(dpa);
      release_v(it);
      ds_tile(sa, dpa, lse_r, delta_r, 64 * it, s_kv, t, qscale);
      pack(dsf, sa);
      sm90::wgmma_fence();
      gemm_rs<NCB>(acc, dsf, k_tiles(it));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      fence_dq<NCB>(acc, dsf);
      release_k(it);
    }
  }

  // dQ = scale * acc in bf16, rows < s_q only
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
    store_rows(dq, acc[cb], bh, s_q, d, row0, 64 * cb, warp, g, t, scale);
}

template <int NCB, int NWG, int KST, int VST, bool kOverlap>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq, int bh, int s_q, int s_kv,
                    int d, float qscale, float scale, cudaStream_t stream) {
  using L = DqTiles<NCB, NWG, KST, VST>;
  auto kernel = flash_bwd_dq_wgmma_kernel<NCB, NWG, KST, VST, kOverlap>;
  const long long n_qt = (s_q + 64 * NWG - 1) / (64 * NWG);
  if (n_qt * bh > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg moves registers between the warpgroups of a fixed pool: it
  // needs the launch to hold kLaunchRegs a thread, or the consumers would wait forever
  if (NWG == 2 && attr.numRegs != kLaunchRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int map_err = sm90::make_tile_map(&tm_q, q, bh, s_q, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_k, k, bh, s_kv, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_v, v, bh, s_kv, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_do, dout, bh, s_q, d);
  if (map_err) return map_err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_qt * bh), 128 * (NWG + 1), L::total, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq),
      static_cast<int>(n_qt), s_q, s_kv, d, qscale, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int bh, int s_q, int s_kv,
                int d, float qscale, float scale, cudaStream_t st) {
  if (d <= 64)
    return launch_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                    scale, st);
  if (d <= 128)
    return launch_dq<T, 128, 64, 64>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                     scale, st);
  return launch_dq<T, 256, 32, 32>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                   scale, st);
}

int dispatch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int bh, int s_q, int s_kv,
                     int d, float qscale, float scale, cudaStream_t st) {
  if (d % 16 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                      scale, st);
  if (d <= 64)
    return launch_dq_wgmma<1, 2, 4, 4, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d,
                                             qscale, scale, st);
  if (d <= 128)
    return launch_dq_wgmma<2, 2, 3, 3, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d,
                                             qscale, scale, st);
  if (d <= 192)
    return launch_dq_wgmma<3, 2, 3, 2, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d,
                                             qscale, scale, st);
  return launch_dq_wgmma<4, 2, 2, 1, false>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d,
                                            qscale, scale, st);
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores in 3xTF32 (d a multiple of 8, 16-byte aligned)
// ---------------------------------------------------------------------------

template <int NR, int BK, int STAGES>
size_t dq_tf32_smem_bytes(int d) {
  return sizeof(float) * static_cast<size_t>(2 * 16 * NR + 2 * STAGES * BK) * (d + 4);
}

// dQ: one block per (query tile of 16 NR rows, bh), 2 NR warps: warps w and
// w + NR own rows 16w .. 16w + 15, w the first half of each key tile and
// w + NR the second, each with its own partial dQ; the two are added at the
// end (in that order).  Shared: Q, dO (16 NR x ld each), then STAGES tiles
// of K and V (BK x ld each); the partials pass through Q's and dO's space.
template <int DMAX, int NR, int BK, int STAGES>
__global__ void __launch_bounds__(64 * NR, 1)
    flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, int s_q, int s_kv, int d, float qscale,
                             float scale) {
  constexpr int NT = 64 * NR;
  constexpr int BQ = 16 * NR;
  constexpr int NS = BK / 16;   // score n-tiles of 8 keys a warp
  constexpr int NO = DMAX / 8;  // dQ n-tiles of 8 dims
  extern __shared__ __align__(16) float smem_f[];
  const int ld = d + 4;
  float* qs = smem_f;
  float* dos = qs + BQ * ld;
  float* kv_tiles = dos + BQ * ld;  // [stage]: K then V of a key tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp % NR;
  const int wrow = 16 * rg;
  const int wkey = (warp / NR) * (BK / 2);
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const float* kb = k + static_cast<size_t>(bh) * s_kv * d;
  const float* vb = v + static_cast<size_t>(bh) * s_kv * d;

  load_rows<BQ, NT>(qs, q + static_cast<size_t>(bh) * s_q * d, q0, s_q, d, ld);
  load_rows<BQ, NT>(dos, dout + static_cast<size_t>(bh) * s_q * d, q0, s_q, d, ld);
  auto load_tile = [&](int kt, int stage) {
    float* dst = kv_tiles + stage * 2 * BK * ld;
    load_rows<BK, NT>(dst, kb, kt, s_kv, d, ld);
    load_rows<BK, NT>(dst + BK * ld, vb, kt, s_kv, d, ld);
  };
  load_tile(0, 0);
  cp_async_commit();

  // this thread's rows: wrow + g (accumulator elements 0, 1) and + 8 (2, 3)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wrow + g + 8 * h;
    const bool ok = row < s_q;
    lse_r[h] = ok ? lse[static_cast<size_t>(bh) * s_q + row] : 0.f;
    delta_r[h] = ok ? delta[static_cast<size_t>(bh) * s_q + row] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

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
    const float* ks = kv_tiles + (it % STAGES) * 2 * BK * ld + wkey * ld;
    const float* vs = ks + BK * ld;
    const int k0 = kt + wkey;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    scores2_3xtf32<NS, NT <= 256 ? 2 : 1>(s, qs + wrow * ld, ks, dp, dos + wrow * ld, vs, ld, d,
                                          lane);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = score_ds(s[n][e], dp[n][e], lse_r[e >> 1], delta_r[e >> 1],
                           q0 + wrow + g + 8 * (e >> 1), k0 + 8 * n + 2 * t + (e & 1), s_q,
                           s_kv, qscale);
    grads_3xtf32<NS, NO>(acc, s, ks, ld, d, g, t);  // dQ += dS K
  }
  // the second key half's partial to the first, through Q's and dO's space
  float* part = qs + rg * (d / 8) * 128;
  __syncthreads();  // every warp is done with the last tile
  if (warp >= NR) {
#pragma unroll
    for (int c = 0; c < NO; ++c)
      if (8 * c < d)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(c * 4 + e) * 32 + lane] = acc[c][e];
  }
  __syncthreads();
  if (warp >= NR) return;
#pragma unroll
  for (int c = 0; c < NO; ++c)
    if (8 * c < d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += part[(c * 4 + e) * 32 + lane];
  store_frag_rows<NO>(dq + static_cast<size_t>(bh) * s_q * d, acc, q0 + wrow, s_q, d, g, t,
                      scale);
}

template <int DMAX, int NR, int BK, int STAGES>
int launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int bh, int s_q, int s_kv,
                   int d, float qscale, float scale, cudaStream_t stream) {
  if (bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dq_tf32_smem_bytes<NR, BK, STAGES>(d);
  auto kernel = flash_bwd_dq_tf32_kernel<DMAX, NR, BK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_q + 16 * NR - 1) / (16 * NR), bh);
  kernel<<<grid, 64 * NR, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), s_q, s_kv, d, qscale,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq, int bh, int s_q, int s_kv,
                    int d, float qscale, float scale, cudaStream_t st) {
  if (!tf32_fits(d, q, k, v, dout, dq, dq))
    return dispatch_dq<float>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale, scale,
                              st);
  if (d <= 64)
    return launch_dq_tf32<64, 8, 64, 1>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                        scale, st);
  if (d <= 128)
    return launch_dq_tf32<128, 8, 32, 2>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d,
                                         qscale, scale, st);
  return launch_dq_tf32<256, 4, 32, 1>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                       scale, st);
}

int dispatch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv, int bh, int s_q,
                     int s_kv, int d, float qscale, float scale, cudaStream_t st) {
  if (!tf32_fits(d, q, k, v, dout, dk, dv)) {
    const DropoutMask none = make_dropout_mask(0, 0, 0, 0, 0, 1.f);
    return key_tile_backward<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, s_q, s_kv,
                                    d, qscale, scale, 0, none, st);
  }
  if (d <= 64)
    return launch_dkv_tf32<64, 32, 2>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, d,
                                      qscale, scale, st);
  if (d <= 128)
    return launch_dkv_tf32<128, 32, 2>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, d,
                                       qscale, scale, st);
  return launch_dkv_tf32<256, 32, 1>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, d,
                                     qscale, scale, st);
}

bool bad_shape(int bh, int s_q, int s_kv, int d) {
  return bh < 1 || s_q < 1 || s_kv < 1 || d < 1 || d > 256 || (s_q + 31) / 32 > 65535 ||
         (s_kv + 31) / 32 > 65535;
}

}  // namespace

extern "C" {

// q, dout: (bh, s_q, d); k, v: (bh, s_kv, d), contiguous on the device in one
// dtype (0 = float32, 1 = bfloat16).  lse, delta: float32 (bh, s_q).
// qscale = scale * log2(e).  Returns the cudaError_t of the launch.

// dq: (bh, s_q, d) in the input dtype, written.
int ist_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int bh, int s_q, int s_kv,
                     int d, float qscale, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s_q, s_kv, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq_f32(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale, scale, st);
  if (dtype == 1)
    return dispatch_dq_bf16(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv: (bh, s_kv, d) in the input dtype, written.
int ist_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int bh, int s_q,
                      int s_kv, int d, float qscale, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s_q, s_kv, d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, d, qscale, scale,
                            st);
  const DropoutMask none = make_dropout_mask(0, 0, 0, 0, 0, 1.f);
  return key_tile_backward<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, s_q, s_kv, d,
                                  qscale, scale, dtype, none, st);
}

}  // extern "C"
