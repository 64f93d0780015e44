// Unmasked attention forward with an online softmax (FlashAttention style)
// and optional attention-probability dropout, over (bh, S, d) tensors in
// float32 or bfloat16.
//
// Replaces: imagined_speech_translation_tpu/ops/pallas_attention.py:_fwd_kernel
// (called by _fwd_call, _flash_core and flash_attention): the region encoders'
// self-attention (head dim 128 at heads (6,6,6); 96/192 at (8,4,4)) and the
// shared cross-scale attention (head dim 256), all over 1655 tokens.
//
// What bounds it on an H100: arithmetic.  At batch 16 the serving path runs
// about 2.7 TFLOP of attention per batch against ~0.2 GB of q/k/v/o, far above
// the card's ratio of operations to bytes, so the products must run on the
// tensor cores; the (S, S) score matrix never leaves the chip.
//
// Design, two variants chosen by what the call can observe:
//
// * bfloat16 with d % 16 == 0 and 16-byte aligned tensors (every serving
//   shape): the tensor-core kernel below (mma.sync m16n8k16, bf16 in, f32
//   accumulate; four warps of 16 query rows each).  wgmma/TMA tiles are
//   later work.
// * float32, or any other d <= 256: a CUDA-core kernel that keeps float32
//   products exact (tensor cores would round f32 inputs to TF32), bounded by
//   the FMA rate and the shared-memory loads feeding it.
//
// Both: one block per (bh, 64-query tile), looping over key tiles of 64
// (d <= 128) or 32 (d > 128) keys held in dynamic shared memory (up to ~137
// KB at d = 256 in f32, above the 48 KB static limit, so the launch raises
// the block's limit first).  The online softmax runs in f32 with exp2f on
// scores scaled by scale*log2(e); keys >= s_kv score -1e30 and padded V rows
// are zero, as in the TPU kernel.  The output is written in the input dtype,
// and the base-2 logsumexp (m + log2 l) as float32 (bh, s_q) for the
// backward.
//
// Dropout (training): after the online-softmax update each probability is
// replaced by keep ? p / (1 - rate) : 0 before it enters P.V, while the row
// sum l (and so lse) keeps the undropped p, as the TPU kernel does.  The keep
// bit of element (bh, row, col) comes from dropout_mask.cuh, a hash of the
// seed and the element's place in flash_attention's logical tiles, so the
// backward kernel regenerates the same mask without storing it.  The seed is
// a kernel argument drawn on the host.
//
// The CUDA-core variant: 256 threads; Q, K, V and the probability tile in
// shared memory as float32 (bf16 widened on load); each thread owns a
// 4 x (BK/16) tile of scores and a 4 x (DMAX/16) tile of the output in
// registers, q is pre-scaled, and row max/sum are reduced across the 16
// threads of a row with warp shuffles.  Q and K rows use a stride of d + 1
// floats so that 16 threads reading 16 different rows hit 16 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_mask.cuh"

namespace {

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
// bf16 tensor-core version (d a multiple of 16, 16-byte aligned tensors)
// ---------------------------------------------------------------------------
//
// Four warps per block, 16 query rows each, with mma.sync m16n8k16 (bf16 in,
// f32 accumulate) for both products.  Q and the K/V tiles sit in shared
// memory row-major, filled with 16-byte vector copies; fragments come from
// ldmatrix (.trans for V, whose fragments run down the key axis).  Rows are
// padded by 8 elements so the 8 rows of each 8x8 ldmatrix hit distinct
// banks.  Scores leave the first product in f32, are scaled by
// scale*log2(e) and masked there, and the probabilities of a warp's 16 rows
// are repacked from the score accumulators straight into the A fragments of
// the second product (the C and A fragment layouts coincide), rounded to
// bf16 as the plain path rounds them.  Row sums stay per thread and are
// reduced across the 4 lanes of a row once at the end.

constexpr int kMmaThreads = 128;

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

template <int BK>
size_t mma_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kBQ + 2 * BK) * (d + 8);
}

template <int DMAX, int BK>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int s_q, int s_kv, int d, float qscale,
                         DropoutMask drop) {
  constexpr int NS = BK / 8;    // score n-tiles of 8 keys
  constexpr int NO = DMAX / 8;  // output n-tiles of 8 dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = d + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kBQ x ldq
  __nv_bfloat16* ks = qs + kBQ * ldq;                              // BK x ldq
  __nv_bfloat16* vs = ks + BK * ldq;                               // BK x ldq

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int lr = lane % 8;  // ldmatrix: row within the lane's 8x8 matrix
  const int lm = lane / 8;  // ldmatrix: which of the 4 matrices
  const int wrow = (tid / 32) * 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t kv_base = static_cast<size_t>(bh) * s_kv * d;
  const int vecs = d / 8;  // 16-byte vectors per row

  for (int idx = tid; idx < kBQ * vecs; idx += kMmaThreads) {
    const int r = idx / vecs;
    const int c = (idx - r * vecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < s_q)
      val = *reinterpret_cast<const uint4*>(q + q_base + static_cast<size_t>(q0 + r) * d + c);
    *reinterpret_cast<uint4*>(qs + r * ldq + c) = val;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_tiles = (s_kv + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile is consumed; Q is written
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
      *reinterpret_cast<uint4*>(ks + r * ldq + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * ldq + c) = vv;
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kk = 0; kk < d; kk += 16) {
      // A: rows wrow + (0..7 | 8..15) x dims kk + (0..7 | 8..15)
      uint32_t a[4];
      ldmatrix_x4(a, qs + (wrow + lr + 8 * (lm % 2)) * ldq + kk + 8 * (lm / 2));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        // B of key tiles n and n + 1: keys x dims kk + (0..7 | 8..15)
        uint32_t b[4];
        ldmatrix_x4(b, ks + ((n + lm / 2) * 8 + lr) * ldq + kk + 8 * (lm % 2));
        mma_bf16(s[n], a, b[0], b[1]);
        mma_bf16(s[n + 1], a, b[2], b[3]);
      }
    }

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float val = col < s_kv ? s[n][e] * qscale : kNegInf;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;  // the normalizer sums the undropped probabilities
        if (drop.on)
          p = dropout_keep(drop, bh, q0 + wrow + g + 8 * (e >> 1), k0 + n * 8 + 2 * t + (e & 1))
                  ? p * drop.inv_keep
                  : 0.f;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        if (n * 8 < d) {
          // B of dim tiles n and n + 1, transposed: keys j*16 + (0..7 | 8..15)
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (j * 16 + lr + 8 * (lm % 2)) * ldq + (n + lm / 2) * 8);
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float lc = fmaxf(li, 1e-30f);
    const float inv = 1.f / lc;
    const int row = q0 + wrow + g + 8 * i;
    if (row >= s_q) continue;
    __nv_bfloat16* orow = o + q_base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 < d) {
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      }
    }
    if (t == 0) lse[static_cast<size_t>(bh) * s_q + row] = m[i] + log2f(lc);
  }
}

template <int DMAX, int BK>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
               int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<BK>(d);
  auto kernel = flash_fwd_mma_kernel<DMAX, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_q + kBQ - 1) / kBQ);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, s_q, s_kv,
      d, qscale, drop);
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

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                  int s_q, int s_kv, int d, float qscale, const DropoutMask& drop,
                  cudaStream_t st) {
  if (d % 16 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 64) return launch_mma<64, 64>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (d <= 128) return launch_mma<128, 64>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  return launch_mma<256, 32>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
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
  if (dtype == 0) return dispatch<float>(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  if (dtype == 1) return dispatch_bf16(q, k, v, o, lse, bh, s_q, s_kv, d, qscale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
