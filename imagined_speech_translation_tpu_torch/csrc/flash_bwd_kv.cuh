// The key-tile attention backward, shared by the fused backward
// (flash_bwd.cu, with dQ) and the split dK/dV kernel (flash_bwd_split.cu,
// without), over (bh, S, d) tensors in float32 or bfloat16; and the mma.sync
// helpers the split dQ kernel also uses.
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
// adds its share of each dQ tile into a float32 (bh, s_q, d) buffer with
// atomicAdd (the layout of FlashAttention-2); the caller zeroes that buffer
// and casts it afterwards.  Atomics make dQ's summation order, and so its
// last bits, vary from run to run.  Without kDQ nothing is shared between
// blocks: each writes only its own dK/dV rows, and the result is the same
// bits on every launch.
//
// Two variants, chosen by what the call can observe:
//
// * bfloat16 with d % 16 == 0 and 16-byte aligned tensors (every training
//   shape): tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate; four
//   warps).  Per query tile of 64 rows: (A) each warp computes S and dP for
//   16 rows against the block's keys, forms P~ and dS in registers and
//   stores them as bf16 in shared memory; (B) the warps share out the
//   (16-key x 32-dim) pieces of dV += P~^T dO and dK += dS^T Q, reading the
//   transposed operands with ldmatrix.trans, and add them into float32 dK/dV
//   sums kept in shared memory (registers cannot hold them at d = 256);
//   (C, kDQ) they share out the (16-query x 32-dim) pieces of dQ = dS K and
//   atomicAdd them.  Keys per block: 64 at d <= 128, 32 at d = 256 (about
//   158 and 179 KB of dynamic shared memory).
// * float32, or any other d <= 256: CUDA cores in f32 (tensor cores would
//   round f32 inputs to TF32).  256 threads as 16 x 16; K, V, Q, dO, P~ and
//   dS tiles in shared memory as float32 with rows padded by one float; each
//   thread keeps a slice of dK and dV in registers.  Keys and queries per
//   tile: 64 at d <= 128, 32 at d = 256 (about 166 and 140 KB).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_mask.cuh"

namespace {

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

__device__ __forceinline__ Grad score_grad(float s, float dp, float lse, float delta, int bh,
                                           int row, int col, int s_q, int s_kv, float qscale,
                                           const DropoutMask& drop) {
  const float p = exp2f((col < s_kv ? s * qscale : kNegInf) - lse);
  float pt = p;
  if (drop.on) {
    const bool keep = dropout_keep(drop, bh, row, col);
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

template <typename T, int DMAX, int BK, int BQ, bool kDQ>
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
        const Grad gr = score_grad(s[i][j], dp[i][j], lse_s[r], delta_s[r], bh, q0 + r,
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
  auto kernel = flash_bwd_kernel<T, DMAX, BK, BQ, kDQ>;
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
// bf16 tensor-core version (d a multiple of 16, 16-byte aligned tensors)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps
constexpr int kMmaBQ = 64;        // query rows per tile: 16 per warp in phase A
constexpr int kChunk = 32;        // head dims per phase-B/C work item

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lane i addresses row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 x kChunk product C += A B over a depth of `depth` (multiple of 16):
// A's fragments at row-major a (lda) or, with A_TRANS, at the row-major
// storage of A^T; B (depth x kChunk) at row-major b (ldb), read transposed
// into the column fragments.  Dims at or past `d_left` are skipped.
template <bool A_TRANS>
__device__ __forceinline__ void mma_chunk(float (&c)[kChunk / 8][4], const __nv_bfloat16* a,
                                          int lda, const __nv_bfloat16* b, int ldb, int depth,
                                          int d_left, int lane) {
  const int lr = lane % 8;
  const int lm = lane / 8;
  for (int kk = 0; kk < depth; kk += 16) {
    uint32_t af[4];
    if (A_TRANS)  // A[m][k] = S[k][m]: matrix lm covers m + 8 (lm % 2), k + 8 (lm / 2)
      ldmatrix_x4_trans(af, a + (kk + 8 * (lm / 2) + lr) * lda + 8 * (lm % 2));
    else
      ldmatrix_x4(af, a + (lr + 8 * (lm % 2)) * lda + kk + 8 * (lm / 2));
#pragma unroll
    for (int n = 0; n < kChunk / 8; n += 2) {
      if (n * 8 < d_left) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, b + (kk + lr + 8 * (lm % 2)) * ldb + (n + lm / 2) * 8);
        mma_bf16(c[n], af, bf[0], bf[1]);
        mma_bf16(c[n + 1], af, bf[2], bf[3]);
      }
    }
  }
}

template <int BK>
size_t mma_smem_bytes(int d) {
  const size_t ldh = d + 8, ldp = BK + 8, ldf = d + 8;
  return sizeof(__nv_bfloat16) * ((2 * BK + 2 * kMmaBQ) * ldh + 2 * kMmaBQ * ldp) +
         sizeof(float) * (2 * BK * ldf + 2 * kMmaBQ);
}

template <int BK, bool kDQ>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s_q,
                         int s_kv, int d, float qscale, float scale, DropoutMask drop) {
  constexpr int BQ = kMmaBQ;
  constexpr int NS = BK / 8;  // score n-tiles of 8 keys per warp row block
  constexpr int NC = kChunk / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = d + 8;   // bf16 rows of K, V, Q, dO
  const int ldp = BK + 8;  // bf16 rows of P~ and dS
  const int ldf = d + 8;   // float rows of the dK/dV sums
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BK * ldh;
  __nv_bfloat16* qs = vs + BK * ldh;
  __nv_bfloat16* dos = qs + BQ * ldh;
  __nv_bfloat16* pts = dos + BQ * ldh;  // BQ x ldp: P~ [query][key]
  __nv_bfloat16* dss = pts + BQ * ldp;  // BQ x ldp: dS [query][key]
  float* dks = reinterpret_cast<float*>(dss + BQ * ldp);  // BK x ldf
  float* dvs = dks + BK * ldf;                             // BK x ldf
  float* lse_s = dvs + BK * ldf;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lr = lane % 8;
  const int lm = lane / 8;
  const int wrow = warp * 16;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t kv_base = static_cast<size_t>(bh) * s_kv * d;
  const int vecs = d / 8;  // 16-byte vectors per row
  const int chunks = (d + kChunk - 1) / kChunk;

  for (int idx = tid; idx < BK * vecs; idx += kMmaThreads) {
    const int r = idx / vecs;
    const int c = (idx - r * vecs) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0);
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (k0 + r < s_kv) {
      const size_t off = kv_base + static_cast<size_t>(k0 + r) * d + c;
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(ks + r * ldh + c) = kv;
    *reinterpret_cast<uint4*>(vs + r * ldh + c) = vv;
  }
  for (int idx = tid; idx < BK * ldf; idx += kMmaThreads) dks[idx] = dvs[idx] = 0.f;

  for (int q0 = 0; q0 < s_q; q0 += BQ) {
    __syncthreads();  // the previous query tile is consumed; K/V are written
    for (int idx = tid; idx < BQ * vecs; idx += kMmaThreads) {
      const int r = idx / vecs;
      const int c = (idx - r * vecs) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0);
      uint4 dov = make_uint4(0, 0, 0, 0);
      if (q0 + r < s_q) {
        const size_t off = q_base + static_cast<size_t>(q0 + r) * d + c;
        qv = *reinterpret_cast<const uint4*>(q + off);
        dov = *reinterpret_cast<const uint4*>(dout + off);
      }
      *reinterpret_cast<uint4*>(qs + r * ldh + c) = qv;
      *reinterpret_cast<uint4*>(dos + r * ldh + c) = dov;
    }
    for (int r = tid; r < BQ; r += kMmaThreads) {
      const bool ok = q0 + r < s_q;
      lse_s[r] = ok ? lse[static_cast<size_t>(bh) * s_q + q0 + r] : 0.f;
      delta_s[r] = ok ? delta[static_cast<size_t>(bh) * s_q + q0 + r] : 0.f;
    }
    __syncthreads();

    // (A) S and dP for this warp's 16 query rows against the BK keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int kk = 0; kk < d; kk += 16) {
      uint32_t a[4], ad[4];
      ldmatrix_x4(a, qs + (wrow + lr + 8 * (lm % 2)) * ldh + kk + 8 * (lm / 2));
      ldmatrix_x4(ad, dos + (wrow + lr + 8 * (lm % 2)) * ldh + kk + 8 * (lm / 2));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + ((n + lm / 2) * 8 + lr) * ldh + kk + 8 * (lm % 2));
        mma_bf16(s[n], a, b[0], b[1]);
        mma_bf16(s[n + 1], a, b[2], b[3]);
        ldmatrix_x4(b, vs + ((n + lm / 2) * 8 + lr) * ldh + kk + 8 * (lm % 2));
        mma_bf16(dp[n], ad, b[0], b[1]);
        mma_bf16(dp[n + 1], ad, b[2], b[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + g + 8 * h;
      const float lse_r = lse_s[r];
      const float delta_r = delta_s[r];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = n * 8 + 2 * t;
        const Grad g0 = score_grad(s[n][2 * h], dp[n][2 * h], lse_r, delta_r, bh, q0 + r,
                                   k0 + c, s_q, s_kv, qscale, drop);
        const Grad g1 = score_grad(s[n][2 * h + 1], dp[n][2 * h + 1], lse_r, delta_r, bh,
                                   q0 + r, k0 + c + 1, s_q, s_kv, qscale, drop);
        *reinterpret_cast<uint32_t*>(pts + r * ldp + c) = pack_bf16(g0.pt, g1.pt);
        *reinterpret_cast<uint32_t*>(dss + r * ldp + c) = pack_bf16(g0.ds, g1.ds);
      }
    }
    __syncthreads();

    // (B) dV += P~^T dO and dK += dS^T Q, in (16-key x kChunk-dim) pieces
    const int n_b = 2 * (BK / 16) * chunks;
    for (int item = warp; item < n_b; item += kMmaThreads / 32) {
      const bool is_v = item % 2 == 0;
      const int mt = (item / 2) % (BK / 16);
      const int c0 = (item / 2 / (BK / 16)) * kChunk;
      float c[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
      mma_chunk<true>(c, (is_v ? pts : dss) + mt * 16, ldp, (is_v ? dos : qs) + c0, ldh, BQ,
                      d - c0, lane);
      float* sum = is_v ? dvs : dks;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (c0 + n * 8 < d) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* p =
                reinterpret_cast<float2*>(sum + (mt * 16 + g + 8 * h) * ldf + c0 + n * 8 + 2 * t);
            float2 cur = *p;
            cur.x += c[n][2 * h];
            cur.y += c[n][2 * h + 1];
            *p = cur;
          }
        }
      }
    }

    if constexpr (kDQ) {
      // (C) dQ += scale * dS K, in (16-query x kChunk-dim) pieces
      const int n_c = (BQ / 16) * chunks;
      for (int item = warp; item < n_c; item += kMmaThreads / 32) {
        const int mq = item % (BQ / 16);
        const int c0 = (item / (BQ / 16)) * kChunk;
        float c[NC][4];
#pragma unroll
        for (int n = 0; n < NC; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
        mma_chunk<false>(c, dss + mq * 16 * ldp, ldp, ks + c0, ldh, BK, d - c0, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + mq * 16 + g + 8 * h;
          if (row >= s_q) continue;
          float* dq_row = dq + q_base + static_cast<size_t>(row) * d;
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const int col = c0 + n * 8 + 2 * t;
            if (col < d) {
              atomicAdd(dq_row + col, scale * c[n][2 * h]);
              atomicAdd(dq_row + col + 1, scale * c[n][2 * h + 1]);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < BK * d; idx += kMmaThreads) {
    const int r = idx / d;
    const int c = idx - r * d;
    if (k0 + r >= s_kv) continue;
    const size_t off = kv_base + static_cast<size_t>(k0 + r) * d + c;
    dk[off] = __float2bfloat16(dks[r * ldf + c] * scale);
    dv[off] = __float2bfloat16(dvs[r * ldf + c]);
  }
}

template <int BK, bool kDQ>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, float* dq, void* dk, void* dv, int bh, int s_q, int s_kv,
               int d, float qscale, float scale, const DropoutMask& drop, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<BK>(d);
  auto kernel = flash_bwd_mma_kernel<BK, kDQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_kv + BK - 1) / BK);
  using B16 = __nv_bfloat16;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      static_cast<const B16*>(dout), lse, delta, dq, static_cast<B16*>(dk),
      static_cast<B16*>(dv), s_q, s_kv, d, qscale, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// The key-tile backward for a (bh, s, d) problem in dtype 0 (float32) or 1
// (bfloat16): dK, dV and, with kDQ, dQ's float32 atomics.
template <bool kDQ>
int key_tile_backward(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq, void* dk, void* dv,
                      int bh, int s_q, int s_kv, int d, float qscale, float scale, int dtype,
                      const DropoutMask& drop, cudaStream_t st) {
  if (dtype == 1 && d % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(dout)) {
    if (d <= 128)
      return launch_mma<64, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d,
                                 qscale, scale, drop, st);
    return launch_mma<32, kDQ>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d, qscale,
                               scale, drop, st);
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
