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
// the fused kernel's 10; in exchange nothing is shared between blocks.
//
// Design.  On the TPU the dQ kernel keeps the whole key range in VMEM (one
// key block at rate 0) and the dK/dV kernel revisits its output block across
// a sequential query axis.  Blocks on the card run in parallel and in no
// order, so each block owns its output tile and loops over the other axis
// inside the block: the dQ kernel one (bh, query tile) looping over key
// tiles, the dK/dV kernel one (bh, key tile) looping over query tiles (the
// key-tile backward of flash_bwd_kv.cuh without its dQ reductions; in bf16
// its Hopper variant).  No block writes another block's output and no sum
// depends on timing, so two launches on the same inputs give the same bits.
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
// The dQ kernel's two variants, chosen as for the key-tile backward:
//
// * bfloat16 with d % 16 == 0 and 16-byte aligned tensors: tensor cores
//   (mma.sync m16n8k16, bf16 in, f32 accumulate); four warps of 16 query
//   rows.  Per key tile each warp computes S and dP in registers, forms dS
//   there and repacks it straight into the A fragments of dQ += dS K (the C
//   and A fragment layouts coincide), with K read transposed by
//   ldmatrix.trans.  dQ stays in registers: 16 x d per warp, d / 2 floats a
//   thread.  Keys per tile: 64 at d <= 128, 32 at d = 256 (70 and 101 KB of
//   shared memory).
// * float32, or any other d <= 256: CUDA cores in f32.  256 threads as
//   16 x 16; Q, dO, K, V and dS tiles in shared memory as float32 with rows
//   padded by one float; each thread keeps a slice of dQ in registers.  Tiles
//   of 64 queries x 64 keys at d <= 128 and 32 x 32 at d = 256 (149 and 136
//   KB).

#include "flash_bwd_kv.cuh"

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
// dQ, bf16 tensor-core version (d a multiple of 16, 16-byte aligned tensors)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps
constexpr int kMmaBQ = 64;        // query rows per block: 16 per warp

template <int BK>
size_t dq_mma_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(2 * kMmaBQ + 2 * BK) * (d + 8);
}

template <int DMAX, int BK>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int s_q, int s_kv, int d,
                            float qscale, float scale) {
  constexpr int NS = BK / 8;    // score n-tiles of 8 keys
  constexpr int NO = DMAX / 8;  // dQ n-tiles of 8 dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = d + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kMmaBQ x ldh
  __nv_bfloat16* dos = qs + kMmaBQ * ldh;                          // kMmaBQ x ldh
  __nv_bfloat16* ks = dos + kMmaBQ * ldh;                          // BK x ldh
  __nv_bfloat16* vs = ks + BK * ldh;                               // BK x ldh

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row group
  const int t = lane % 4;   // thread in group
  const int lr = lane % 8;  // ldmatrix: row within the lane's 8x8 matrix
  const int lm = lane / 8;  // ldmatrix: which of the 4 matrices
  const int wrow = (tid / 32) * 16;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kMmaBQ;
  const size_t q_base = static_cast<size_t>(bh) * s_q * d;
  const size_t kv_base = static_cast<size_t>(bh) * s_kv * d;
  const int vecs = d / 8;  // 16-byte vectors per row

  for (int idx = tid; idx < kMmaBQ * vecs; idx += kMmaThreads) {
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
  // this thread's rows: wrow + g (fragment elements 0, 1) and + 8 (2, 3)
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
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < s_kv; k0 += BK) {
    __syncthreads();  // the previous key tile is consumed; Q/dO are written
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
    __syncthreads();

    // S and dP for this warp's 16 query rows against the BK keys
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
    // dS over S, on rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = score_ds(s[n][e], dp[n][e], lse_r[e >> 1], delta_r[e >> 1],
                           q0 + wrow + g + 8 * (e >> 1), k0 + n * 8 + 2 * t + (e & 1), s_q,
                           s_kv, qscale);

    // dQ += dS K: dS rounded to bf16 as the A fragments of 16-key slices
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
          ldmatrix_x4_trans(b, ks + (j * 16 + lr + 8 * (lm % 2)) * ldh + (n + lm / 2) * 8);
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wrow + g + 8 * h;
    if (row >= s_q) continue;
    __nv_bfloat16* dq_row = dq + q_base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n * 8 < d) {
        *reinterpret_cast<uint32_t*>(dq_row + n * 8 + 2 * t) =
            pack_bf16(scale * acc[n][2 * h], scale * acc[n][2 * h + 1]);
      }
    }
  }
}

template <int DMAX, int BK>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int bh, int s_q, int s_kv,
                  int d, float qscale, float scale, cudaStream_t stream) {
  const size_t smem = dq_mma_smem_bytes<BK>(d);
  auto kernel = flash_bwd_dq_mma_kernel<DMAX, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_q + kMmaBQ - 1) / kMmaBQ);
  using B16 = __nv_bfloat16;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      static_cast<const B16*>(dout), lse, delta, static_cast<B16*>(dq), s_q, s_kv, d, qscale,
      scale);
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
    return launch_dq_mma<64, 64>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                 scale, st);
  if (d <= 128)
    return launch_dq_mma<128, 64>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale,
                                  scale, st);
  return launch_dq_mma<256, 32>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale, scale,
                                st);
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
    return dispatch_dq<float>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale, scale,
                              st);
  if (dtype == 1)
    return dispatch_dq_bf16(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, qscale, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv: (bh, s_kv, d) in the input dtype, written.
int ist_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int bh, int s_q,
                      int s_kv, int d, float qscale, float scale, int dtype, void* stream) {
  if (bad_shape(bh, s_q, s_kv, d)) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutMask none = make_dropout_mask(0, 0, 0, 0, 0, 1.f);
  return key_tile_backward<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, bh, s_q, s_kv, d,
                                  qscale, scale, dtype, none, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
