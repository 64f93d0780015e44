// The key-tile attention backward, shared by the fused backward
// (flash_bwd.cu, with dQ) and the split dK/dV kernel (flash_bwd_split.cu,
// without), over (bh, S, d) tensors in float32 or bfloat16.
//
// Given the forward's inputs, its base-2 logsumexp lse and delta =
// rowsum(dO * O) (computed by the caller in float32), each block owns one
// (bh, key tile): it keeps its K/V tile and its dK/dV sums on chip, loops over
// all query tiles, recomputes each (q, k) tile's probabilities P = exp2(S *
// scale * log2 e - lse) once and derives the gradients from it:
//
//   dV  = P~^T dO                       P~ = M / (1 - rate) * P (dropped P)
//   dS  = P * (M / (1 - rate) * dP - delta),   dP = dO V^T
//   dK  = scale * dS^T Q
//   dQ  = scale * dS K                  (kDQ only)
//
// with M the keep mask of dropout_mask.cuh (the same function the forward
// applied, so nothing is stored between the two; all ones when dropout is
// off).  Keys >= s_kv score -1e30 (P = 0) and their K/V rows are zero; query
// rows >= s_q contribute nothing.  P~ and dS are rounded to the input dtype
// before their products, as the TPU kernels round them.  With kDQ the block
// adds its share of each dQ tile into a float32 (bh, s_q, d) buffer by
// atomic reductions; the caller zeroes that buffer and casts it afterwards.
// Their order, and so dQ's last bits, vary from run to run.  Without kDQ
// nothing is shared between blocks: each writes only its own dK/dV rows, and
// the result is the same bits on every launch.
//
// Two variants, chosen by what the call can observe:
//
// * bfloat16 with d % 16 == 0 and 16-byte aligned tensors (every training
//   shape): Hopper's wgmma, TMA and mbarriers (sm90.cuh), 384 threads a
//   block.  What bounds it is arithmetic, 10 * bh * s_q * s_kv * d FLOPs
//   (0.340 ms at both training shapes on the tensor cores' 989 TFLOP/s); the
//   design, against what held the mma.sync version that came before it:
//   - transposed, in registers: each consumer warpgroup owns 64 keys and
//     computes S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries) into
//     registers, forms P~^T and dS^T there and feeds them, packed to bf16, as
//     the register A operand of dV += P~^T dO and dK += dS^T Q; only B (dO,
//     Q) is read from shared memory, and no P~ or dS round trip is needed
//     for dK/dV;
//   - dK/dV stay in registers for the whole query loop and are written once.
//     At d <= 128 a block holds 128 keys, two consumer warpgroups of 64 with
//     both sums each (2 x 64 floats a thread at d = 128); at d > 128 (192,
//     256) one warpgroup cannot hold both, so a block holds 64 keys and
//     splits them: warpgroup 0 computes S^T, P~^T and dV, warpgroup 1 dP^T,
//     dS^T and dK, and P passes from 0 to 1 through shared memory as f32
//     with the keep bit in its sign (recomputing S would cost a sixth
//     product).  setmaxnreg gives the consumers 232 registers a thread and
//     the producer 40;
//   - eight consumer warps and a producer warp per block instead of four
//     warps: a producer warp keeps Q, dO, lse and delta tiles in flight in a
//     two-stage ring (Q/dO by TMA with the 128-byte swizzle wgmma reads,
//     lse/delta by the producer's own loads), signalled by mbarriers, so the
//     consumers never wait on a global load;
//   - dQ: dS^T is stored once as bf16 to shared memory, and dQ = dS K runs
//     as wgmma (M = 64 queries) over all of the block's keys, its column
//     blocks shared out between the warpgroups; the f32 partial goes into
//     dQ by 4-float vector reductions, never scalar atomics.  At d <= 128
//     the 128-key block halves the partial sums of a 64-key one;
//   - the dropout mask: where the logical tiles are multiples of the
//     kernel's 64 x 64 tiles the hash input is computed once per tile
//     (dropout_tile_base), not with two divisions per element; other
//     logical tiles keep dropout_keep per element.  Both give the same bits.
//   Shared memory: 162.0 KB (d = 128) and 218.0 KB (d = 256) of the 227
//   KB a block may have.  Blocks start their query loops at different
//   tiles so their dQ reductions spread over the rows.
// * any other case, float32 or bfloat16: CUDA cores in f32.  256 threads as
//   16 x 16; K, V, Q, dO, P~ and dS tiles in shared memory as float32 with
//   rows padded by one float; each thread keeps a slice of dK and dV in
//   registers.  Keys and queries per tile: 64 at d <= 128, 32 at d = 256
//   (about 166 and 140 KB).  In float32 it runs only where the 3xTF32
//   tensor-core kernel of flash_bwd_tf32.cuh, which takes the fused and the
//   split dK/dV backward otherwise, does not apply: d % 8 != 0 or tensors
//   not 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_mask.cuh"
#include "sm90.cuh"

namespace {

using sm90::fence_frags;
using sm90::pack;
using sm90::pack_bf16;
using sm90::zero;

constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T and widened back: the rounding of P~ and dS before their products
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// P~ and dS of one score element; zero outside the valid rows.
struct Grad {
  float pt, ds;
};

template <bool kMap>
__device__ __forceinline__ Grad score_grad(float s, float dp, float lse, float delta, int bh,
                                           int row, int col, int s_q, int s_kv, float qscale,
                                           const DropoutMask& drop) {
  const float p = exp2f((col < s_kv ? s * qscale : kNegInf) - lse);
  float pt = p;
  if (drop.on) {
    const bool keep = dropout_keep<kMap>(drop, bh, row, col);
    pt = keep ? p * drop.inv_keep : 0.f;
    dp = keep ? dp * drop.inv_keep : 0.f;
  }
  if (row >= s_q) return Grad{0.f, 0.f};
  return Grad{pt, p * (dp - delta)};
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------------------
// CUDA-core version
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16

template <int BK, int BQ>
size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(2 * BK + 2 * BQ) * (d + 1) +
                          static_cast<size_t>(2 * BQ) * (BK + 1) + 2 * BQ);
}

template <typename T, int DMAX, int BK, int BQ, bool kDQ, bool kMap>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv, int s_q, int s_kv, int d,
                     float qscale, float scale, DropoutMask drop) {
  constexpr int KPT = BK / 16;    // key rows (and score columns) per thread
  constexpr int RPT = BQ / 16;    // query rows per thread
  constexpr int DPT = DMAX / 16;  // head dims per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  const int pld = BK + 1;
  float* ks = smem;            // BK x ld
  float* vs = ks + BK * ld;    // BK x ld
  float* qs = vs + BK * ld;    // BQ x ld
  float* dos = qs + BQ * ld;   // BQ x ld
  float* ps = dos + BQ * ld;   // BQ x pld: P~
  float* dss = ps + BQ * pld;  // BQ x pld: dS
  float* lse_s = dss + BQ * pld;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t kv_base = static_cast<size_t>(bh) * s_kv * d;
  const T zero = T(0.f);

  for (int idx = tid; idx < BK * d; idx += kThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    const bool ok = k0 + r < s_kv;
    const size_t gi = kv_base + static_cast<size_t>(k0 + r) * d + c;
    ks[r * ld + c] = to_f32(ok ? k[gi] : zero);
    vs[r * ld + c] = to_f32(ok ? v[gi] : zero);
  }

  float dk_acc[KPT][DPT], dv_acc[KPT][DPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < s_q; q0 += BQ) {
    __syncthreads();  // the previous query tile is consumed; K/V are written
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
        const Grad gr = score_grad<kMap>(s[i][j], dp[i][j], lse_s[r], delta_s[r], bh, q0 + r,
                                   k0 + c, s_q, s_kv, qscale, drop);
        ps[r * pld + c] = round_to(gr.pt, zero);
        dss[r * pld + c] = round_to(gr.ds, zero);
      }
    }
    __syncthreads();

    // dV += P~^T dO and dK += dS^T Q for keys ty + 16 i, dims tx + 16 c
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[KPT], dsv[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        pv[i] = ps[r * pld + ty + 16 * i];
        dsv[i] = dss[r * pld + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx + 16 * c;
        const float dov = col < d ? dos[r * ld + col] : 0.f;
        const float qv = col < d ? qs[r * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
        }
      }
    }

    if constexpr (kDQ) {
      // dQ += scale * dS K for query rows ty + 16 i, dims tx + 16 c
      float acc[RPT][DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
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
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= s_q) continue;
        float* dq_row = dq + q_base + static_cast<size_t>(row) * d;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int col = tx + 16 * c;
          if (col < d) atomicAdd(dq_row + col, scale * acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s_kv) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        store(dk + kv_base + static_cast<size_t>(row) * d + col, dk_acc[i][c] * scale);
        store(dv + kv_base + static_cast<size_t>(row) * d + col, dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int DMAX, int BK, int BQ, bool kDQ>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq, void* dk, void* dv, int bh, int s_q, int s_kv, int d,
           float qscale, float scale, const DropoutMask& drop, cudaStream_t stream) {
  const size_t smem = smem_bytes<BK, BQ>(d);
  auto kernel = flash_bwd_kernel<T, DMAX, BK, BQ, kDQ, false>;
  if constexpr (kDQ) {  // the fused backward, the one with dropout
    if (dropout_mapped(drop)) kernel = flash_bwd_kernel<T, DMAX, BK, BQ, kDQ, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_kv + BK - 1) / BK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, dq, static_cast<T*>(dk), static_cast<T*>(dv),
      s_q, s_kv, d, qscale, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 Hopper version (d a multiple of 16, 16-byte aligned tensors)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kWgBQ = 64;            // query rows per tile
constexpr int kStages = 2;           // depth of the query-tile ring
constexpr int kTile = 64 * 64 * 2;   // bytes of one 64 x 64 bf16 tile
constexpr int kConsumerRegs = 232;   // setmaxnreg: 2 x 128 x 232 + 128 x 40 = 65,536 - 1,024
constexpr int kProducerRegs = 40;
constexpr int kLaunchRegs = 168;     // what __launch_bounds__(384, 1) gives every thread
enum : int { kBarP = 1, kBarDS = 2 };  // named barriers between the consumer warpgroups

// Shared memory of one block, in bytes from a 1024-byte aligned base.  NCB:
// 64-wide column blocks of the head dim; kSplit: d > 128, where warpgroup 0
// holds dV and warpgroup 1 dK of the same 64 keys (else each holds both for
// its own 64 of 128 keys).
template <int NCB, bool kSplit, bool kDQ>
struct WgLayout {
  static constexpr int BK = kSplit ? 64 : 128;         // keys per block
  static constexpr int kv_bytes = NCB * BK * 128;      // K (or V): NCB tiles of BK rows
  static constexpr int k = 0;
  static constexpr int v = kv_bytes;
  static constexpr int stage = 2 * kv_bytes;           // ring: Q then dO, NCB tiles each
  static constexpr int stage_bytes = 2 * NCB * kTile;
  static constexpr int ds = stage + kStages * stage_bytes;  // dS^T, bf16 [key][query]
  static constexpr int ds_bytes = kDQ ? (kSplit ? 1 : 2) * BK * 128 : 0;
  static constexpr int p = ds + ds_bytes;              // kSplit: +-P, f32 [element][thread]
  static constexpr int p_bytes = kSplit ? 32 * 128 * 4 : 0;
  static constexpr int rows = p + p_bytes;             // lse, delta: [stage][2][64] f32
  static constexpr int bars = rows + kStages * 2 * kWgBQ * 4;
  static constexpr int total = bars + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
  static_assert(total <= 232448, "shared memory of one block");
};

// The keep bits of this thread's 32 score elements (bit j: element j of the
// accumulator layout, key row key0 + 16 warp + g + 8 h, query column q0 +
// 8 i + 2 t + e).  Where the kernel tile lies inside one logical tile the
// hash input is hoisted out of the loop; otherwise each element divides.
template <bool kMap>
__device__ __forceinline__ uint32_t keep_bits(const DropoutMask& m, int bh, int q0, int key0,
                                              int warp, int g, int t) {
  uint32_t bits = 0;
  const int r = 16 * warp + g;
  if (m.block_q % kWgBQ == 0 && m.block_k % 64 == 0) {
    const uint32_t base = dropout_tile_base<kMap>(m, bh, q0, key0) +
                          static_cast<uint32_t>(2 * t * m.block_k + r);
    const uint32_t bk = static_cast<uint32_t>(m.block_k);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t c = 8 * (j / 4) + j % 2;
      bits |= static_cast<uint32_t>(dropout_keep_at(m, base, c * bk + 8 * ((j / 2) % 2))) << j;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * (j / 4) + 2 * t + j % 2;
      bits |= static_cast<uint32_t>(
                  dropout_keep<kMap>(m, bh, q0 + c, key0 + r + 8 * ((j / 2) % 2)))
              << j;
    }
  }
  return bits;
}

// acc (64 queries x 64 dims, accumulator layout) * scale added into the f32
// dQ rows q0 + 16 warp + .. of head bh, columns col0 + ..: neighbouring lanes
// swap half their pairs so each adds 4 consecutive floats with one vector
// reduction (red.global.add.v4.f32, which sm_90's float4 atomicAdd is when
// its result is unused).
__device__ __forceinline__ void add_dq(float* dq, const float (&acc)[32], int bh, int s_q, int d,
                                       int q0, int col0, int warp, int g, int t, float scale) {
  const bool even = t % 2 == 0;
  const int row = q0 + 16 * warp + g + (even ? 0 : 8);
  const bool row_ok = row < s_q;
  float* base = dq + (static_cast<size_t>(bh) * s_q + row) * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s0 = even ? acc[4 * i + 2] : acc[4 * i];
    const float s1 = even ? acc[4 * i + 3] : acc[4 * i + 1];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const int col = col0 + 8 * i + 2 * (t & ~1);
    const float4 v = even ? make_float4(acc[4 * i], acc[4 * i + 1], r0, r1)
                          : make_float4(r0, r1, acc[4 * i + 2], acc[4 * i + 3]);
    if (row_ok && col < d) {
      atomicAdd(reinterpret_cast<float4*>(base + col),
                make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale));
    }
  }
}

// Writes acc * scale (64 keys x 64 dims of one column block, accumulator
// layout) as bf16 rows key0 + 16 warp + .. of head bh, columns col0 + ..
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[32], int bh,
                                           int s_kv, int d, int key0, int col0, int warp, int g,
                                           int t, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = key0 + 16 * warp + g + 8 * h;
    if (row >= s_kv) continue;
    __nv_bfloat16* base = out + (static_cast<size_t>(bh) * s_kv + row) * d;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = col0 + 8 * i + 2 * t;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(base + col) =
            __floats2bfloat162_rn(acc[4 * i + 2 * h] * scale, acc[4 * i + 2 * h + 1] * scale);
      }
    }
  }
}

// Stores this thread's packed dS^T pairs (rows row0 + 16 warp + .. of a
// [key][query] bf16 tile in the 128-byte swizzle) for the dQ product.
__device__ __forceinline__ void store_ds(unsigned char* tile, const uint32_t (&ds)[4][4],
                                         int row0, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * warp + g + 8 * h;  // r % 8 == g
      *reinterpret_cast<uint32_t*>(tile + r * 128 + ((i ^ g) << 4) + 4 * t) =
          ds[i / 2][2 * (i % 2) + h];
    }
  }
}

// acc = A B over one warpgroup's 64 rows: A (64 x NCB*64) K-major tiles at
// a (tile stride a_cb), B^T (64 x NCB*64) K-major tiles at b (stride kTile).
template <int NCB>
__device__ __forceinline__ void gemm_kmajor(float (&acc)[32], uint32_t a, int a_cb, uint32_t b) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss<0, 0>(acc, sm90::desc_b128(a + cb * a_cb + 32 * kk),
                           sm90::desc_b128(b + cb * kTile + 32 * kk), 1);
}

// acc[cb] += A B[cb] with A (64 x 64, K = 64 queries) in registers and B the
// MN-major tiles at b (64 query rows each, stride kTile).
template <int NCB>
__device__ __forceinline__ void gemm_rs(float (&acc)[NCB][32], const uint32_t (&a)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      sm90::wgmma_rs<1>(acc[cb], a[ks], sm90::desc_b128(b + cb * kTile + 2048 * ks), 1);
}

// dQ's column blocks cb = first, first + 2, ..: dS (64 queries x BK keys,
// the MN-major dS^T tile at ds) times K (the MN-major tiles at k, stride
// k_cb), added into dq.
template <int NCB, int BK>
__device__ __forceinline__ void dq_blocks(float* dq, uint32_t ds, uint32_t k, int k_cb,
                                          int first, int bh, int s_q, int d, int q0, int warp,
                                          int g, int t, float scale) {
  for (int cb = first; cb < NCB; cb += 2) {
    float acc[32];
    zero(acc);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      sm90::wgmma_ss<1, 1>(acc, sm90::desc_b128(ds + 2048 * ks),
                           sm90::desc_b128(k + cb * k_cb + 2048 * ks), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    add_dq(dq, acc, bh, s_q, d, q0, 64 * cb, warp, g, t, scale);
  }
}

// P~ (or dS) of one element of the accumulator layout, as score_grad forms it.
struct WgTile {
  const float* lse;    // this stage's 64 lse values
  const float* delta;  // and 64 delta values
  int q0, key0, s_q, s_kv, g, t, warp;
  __device__ __forceinline__ int col(int j) const { return 8 * (j / 4) + 2 * t + j % 2; }
  __device__ __forceinline__ int key(int j) const {
    return key0 + 16 * warp + g + 8 * ((j / 2) % 2);
  }
  __device__ __forceinline__ float p(float s, int j, float qscale) const {
    return exp2f((key(j) < s_kv ? s * qscale : kNegInf) - lse[col(j)]);
  }
  __device__ __forceinline__ bool valid(int j) const { return q0 + col(j) < s_q; }
};

template <int NCB, bool kSplit, bool kDQ, bool kMap>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int s_q, int s_kv, int d,
                           float qscale, float scale, DropoutMask drop) {
  using L = WgLayout<NCB, kSplit, kDQ>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  float* rows = reinterpret_cast<float*>(smem + L::rows);
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int k0 = kt * L::BK;
  const int n_qt = (s_q + kWgBQ - 1) / kWgBQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 33);  // the producer lanes + lane 0's byte count
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_init(kv_full, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one warp keeps the ring of Q, dO, lse and delta tiles full
    sm90::reg_dealloc<kProducerRegs>();
    if (warp == 0) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kv_bytes);
        for (int cb = 0; cb < NCB; ++cb)
          for (int r = 0; r < L::BK / 64; ++r) {
            const int off = cb * L::BK * 128 + r * kTile;
            sm90::tma_load_3d(smem + L::k + off, &tm_k, kv_full, 64 * cb, k0 + 64 * r, bh);
            sm90::tma_load_3d(smem + L::v + off, &tm_v, kv_full, 64 * cb, k0 + 64 * r, bh);
          }
      }
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int q0 = ((it + kt) % n_qt) * kWgBQ;  // blocks start apart: dQ adds spread
        unsigned char* st = smem + L::stage + s * L::stage_bytes;
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], L::stage_bytes);
          for (int cb = 0; cb < NCB; ++cb) {
            sm90::tma_load_3d(st + cb * kTile, &tm_q, &full[s], 64 * cb, q0, bh);
            sm90::tma_load_3d(st + (NCB + cb) * kTile, &tm_do, &full[s], 64 * cb, q0, bh);
          }
        }
        float* r = rows + s * 2 * kWgBQ;
        for (int j = lane; j < kWgBQ; j += 32) {
          const bool ok = q0 + j < s_q;
          const size_t gi = static_cast<size_t>(bh) * s_q + q0 + j;
          r[j] = ok ? lse[gi] : 0.f;
          r[kWgBQ + j] = ok ? delta[gi] : 0.f;
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers
    sm90::reg_alloc<kConsumerRegs>();
    const int g = lane / 4;
    const int t = lane % 4;
    const int tid = threadIdx.x % 128;
    const uint32_t ks = sm90::smem_u32(smem + L::k);
    const uint32_t vs = sm90::smem_u32(smem + L::v);
    constexpr int kv_cb = L::BK * 128;  // bytes between K's (or V's) column-block tiles
    sm90::mbar_wait(kv_full, 0);

    if constexpr (!kSplit) {
      // each warpgroup: keys key0 .. key0 + 63, dK and dV in registers
      const int key0 = k0 + 64 * wg;
      float dk_acc[NCB][32], dv_acc[NCB][32];
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        zero(dk_acc[cb]);
        zero(dv_acc[cb]);
      }
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kStages;
        const int q0 = ((it + kt) % n_qt) * kWgBQ;
        const uint32_t st = sm90::smem_u32(smem + L::stage + s * L::stage_bytes);
        const uint32_t dos = st + NCB * kTile;
        sm90::mbar_wait(&full[s], (it / kStages) & 1);

        // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
        float sa[32], dpa[32];
        zero(sa);
        zero(dpa);
        sm90::fence_regs(sa);
        sm90::fence_regs(dpa);
        sm90::wgmma_fence();
        gemm_kmajor<NCB>(sa, ks + wg * kTile, kv_cb, st);
        gemm_kmajor<NCB>(dpa, vs + wg * kTile, kv_cb, dos);
        sm90::wgmma_commit();
        uint32_t keep = ~0u;
        if (drop.on) keep = keep_bits<kMap>(drop, bh, q0, key0, warp, g, t);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sa);
        sm90::fence_regs(dpa);

        // P~^T and dS^T in registers, rounded to bf16 as the A operands
        const WgTile tile{rows + s * 2 * kWgBQ, rows + s * 2 * kWgBQ + kWgBQ, q0, key0, s_q,
                          s_kv, g, t, warp};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float p = tile.p(sa[j], j, qscale);
          float pt = p, dp = dpa[j];
          if (drop.on) {
            const bool kp = (keep >> j) & 1u;
            pt = kp ? p * drop.inv_keep : 0.f;
            dp = kp ? dp * drop.inv_keep : 0.f;
          }
          const bool ok = tile.valid(j);
          sa[j] = ok ? pt : 0.f;
          dpa[j] = ok ? p * (dp - tile.delta[tile.col(j)]) : 0.f;
        }
        uint32_t pf[4][4], dsf[4][4];
        pack(pf, sa);
        pack(dsf, dpa);

        // dV += P~^T dO and dK += dS^T Q, the A operands from registers
        sm90::wgmma_fence();
        gemm_rs<NCB>(dv_acc, pf, dos);
        gemm_rs<NCB>(dk_acc, dsf, st);
        sm90::wgmma_commit();
        if constexpr (kDQ) {
          // both warpgroups' dS^T (128 keys) into this tile's buffer
          store_ds(smem + L::ds + (it & 1) * L::BK * 128, dsf, 64 * wg, warp, g, t);
          sm90::fence_async_shared();
          sm90::bar_sync(kBarDS, 256);
        }
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          sm90::fence_regs(dv_acc[cb]);
          sm90::fence_regs(dk_acc[cb]);
        }
        fence_frags(pf);
        fence_frags(dsf);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);  // Q and dO of this stage are consumed

        if constexpr (kDQ) {
          // dQ = dS K over all 128 keys; column blocks shared out between the warpgroups
          dq_blocks<NCB, L::BK>(dq, sm90::smem_u32(smem + L::ds + (it & 1) * L::BK * 128), ks,
                                kv_cb, wg, bh, s_q, d, q0, warp, g, t, scale);
        }
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        store_rows(dk, dk_acc[cb], bh, s_kv, d, key0, 64 * cb, warp, g, t, scale);
        store_rows(dv, dv_acc[cb], bh, s_kv, d, key0, 64 * cb, warp, g, t, 1.f);
      }
    } else if (wg == 0) {
      // d > 128, warpgroup 0: S^T, P~^T, dV; hands +-P (the sign: dropped) to warpgroup 1
      float* pbuf = reinterpret_cast<float*>(smem + L::p);
      float dv_acc[NCB][32];
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) zero(dv_acc[cb]);
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kStages;
        const int q0 = ((it + kt) % n_qt) * kWgBQ;
        const uint32_t st = sm90::smem_u32(smem + L::stage + s * L::stage_bytes);
        sm90::mbar_wait(&full[s], (it / kStages) & 1);
        float sa[32];
        zero(sa);
        sm90::fence_regs(sa);
        sm90::wgmma_fence();
        gemm_kmajor<NCB>(sa, ks, kv_cb, st);
        sm90::wgmma_commit();
        uint32_t keep = ~0u;
        if (drop.on) keep = keep_bits<kMap>(drop, bh, q0, k0, warp, g, t);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sa);
        const WgTile tile{rows + s * 2 * kWgBQ, rows + s * 2 * kWgBQ + kWgBQ, q0, k0, s_q, s_kv,
                          g, t, warp};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float p = tile.p(sa[j], j, qscale);
          const bool kp = (keep >> j) & 1u;
          pbuf[j * 128 + tid] = kp ? p : -p;
          float pt = p;
          if (drop.on) pt = kp ? p * drop.inv_keep : 0.f;
          sa[j] = tile.valid(j) ? pt : 0.f;
        }
        sm90::bar_arrive(kBarP, 256);
        uint32_t pf[4][4];
        pack(pf, sa);
        sm90::wgmma_fence();
        gemm_rs<NCB>(dv_acc, pf, st + NCB * kTile);
        sm90::wgmma_commit();
        sm90::bar_sync(kBarDS, 256);  // warpgroup 1 has read P (and stored dS^T)
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) sm90::fence_regs(dv_acc[cb]);
        fence_frags(pf);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
        if constexpr (kDQ) {
          dq_blocks<NCB, L::BK>(dq, sm90::smem_u32(smem + L::ds), ks, kv_cb, 0, bh, s_q, d, q0,
                                warp, g, t, scale);
        }
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        store_rows(dv, dv_acc[cb], bh, s_kv, d, k0, 64 * cb, warp, g, t, 1.f);
    } else {
      // d > 128, warpgroup 1: dP^T, dS^T (from warpgroup 0's P), dK
      const float* pbuf = reinterpret_cast<const float*>(smem + L::p);
      float dk_acc[NCB][32];
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) zero(dk_acc[cb]);
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kStages;
        const int q0 = ((it + kt) % n_qt) * kWgBQ;
        const uint32_t st = sm90::smem_u32(smem + L::stage + s * L::stage_bytes);
        sm90::mbar_wait(&full[s], (it / kStages) & 1);
        float dpa[32];
        zero(dpa);
        sm90::fence_regs(dpa);
        sm90::wgmma_fence();
        gemm_kmajor<NCB>(dpa, vs, kv_cb, st + NCB * kTile);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dpa);
        const WgTile tile{rows + s * 2 * kWgBQ, rows + s * 2 * kWgBQ + kWgBQ, q0, k0, s_q, s_kv,
                          g, t, warp};
        sm90::bar_sync(kBarP, 256);  // warpgroup 0's +-P of this tile
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float x = pbuf[j * 128 + tid];
          const float p = fabsf(x);
          float dp = dpa[j];
          if (drop.on) dp = signbit(x) ? 0.f : dp * drop.inv_keep;
          dpa[j] = tile.valid(j) ? p * (dp - tile.delta[tile.col(j)]) : 0.f;
        }
        uint32_t dsf[4][4];
        pack(dsf, dpa);
        sm90::wgmma_fence();
        gemm_rs<NCB>(dk_acc, dsf, st);
        sm90::wgmma_commit();
        if constexpr (kDQ) {
          store_ds(smem + L::ds, dsf, 0, warp, g, t);
          sm90::fence_async_shared();
          sm90::bar_sync(kBarDS, 256);
        } else {
          sm90::bar_arrive(kBarDS, 256);
        }
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) sm90::fence_regs(dk_acc[cb]);
        fence_frags(dsf);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
        if constexpr (kDQ) {
          dq_blocks<NCB, L::BK>(dq, sm90::smem_u32(smem + L::ds), ks, kv_cb, 1, bh, s_q, d, q0,
                                warp, g, t, scale);
        }
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        store_rows(dk, dk_acc[cb], bh, s_kv, d, k0, 64 * cb, warp, g, t, scale);
    }
  }
}

template <int NCB, bool kSplit, bool kDQ>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, float* dq, void* dk, void* dv, int bh, int s_q, int s_kv,
                 int d, float qscale, float scale, const DropoutMask& drop, cudaStream_t stream) {
  using L = WgLayout<NCB, kSplit, kDQ>;
  auto kernel = flash_bwd_wgmma_kernel<NCB, kSplit, kDQ, false>;
  if constexpr (kDQ) {  // the fused backward, the one with dropout
    if (dropout_mapped(drop)) kernel = flash_bwd_wgmma_kernel<NCB, kSplit, kDQ, true>;
  }
  if (bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // setmaxnreg moves registers between the warpgroups of a fixed pool: it
  // needs the launch to hold kLaunchRegs a thread, or the consumers would wait forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != kLaunchRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int map_err = sm90::make_tile_map(&tm_q, q, bh, s_q, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_k, k, bh, s_kv, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_v, v, bh, s_kv, d);
  if (!map_err) map_err = sm90::make_tile_map(&tm_do, dout, bh, s_q, d);
  if (map_err) return map_err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_kv + L::BK - 1) / L::BK, bh);
  kernel<<<grid, kWgThreads, L::total, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, dq, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s_q, s_kv, d, qscale, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// The key-tile backward for a (bh, s, d) problem in dtype 0 (float32) or 1
// (bfloat16): dK, dV and, with kDQ, dQ's float32 reductions.
template <bool kDQ>
int key_tile_backward(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq, void* dk, void* dv,
                      int bh, int s_q, int s_kv, int d, float qscale, float scale, int dtype,
                      const DropoutMask& drop, cudaStream_t st) {
  if (dtype == 1 && d % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(dout)) {
    if (d <= 64)
      return launch_wgmma<1, false, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d,
                                         qscale, scale, drop, st);
    if (d <= 128)
      return launch_wgmma<2, false, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d,
                                         qscale, scale, drop, st);
    if (d <= 192)
      return launch_wgmma<3, true, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d,
                                        qscale, scale, drop, st);
    return launch_wgmma<4, true, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d,
                                      qscale, scale, drop, st);
  }
  if (dtype == 0) {
    if (d <= 64)
      return launch<float, 64, 64, 64, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q,
                                            s_kv, d, qscale, scale, drop, st);
    if (d <= 128)
      return launch<float, 128, 64, 64, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q,
                                             s_kv, d, qscale, scale, drop, st);
    return launch<float, 256, 32, 32, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q,
                                           s_kv, d, qscale, scale, drop, st);
  }
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    if (d <= 64)
      return launch<B16, 64, 64, 64, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv,
                                          d, qscale, scale, drop, st);
    if (d <= 128)
      return launch<B16, 128, 64, 64, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q,
                                           s_kv, d, qscale, scale, drop, st);
    return launch<B16, 256, 32, 32, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv,
                                         d, qscale, scale, drop, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
