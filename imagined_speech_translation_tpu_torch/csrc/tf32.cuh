// Float32 products on the tensor cores in 3xTF32, shared by the kernels that
// run them: the flash forward (flash_fwd.cu) and the split backward
// (flash_bwd_split.cu).
//
// mma.sync m16n8k8 in TF32 with f32 accumulators.  Each operand x is split in
// registers, as its fragment is loaded, into big and small (below); a product
// is a_small b_big + a_big b_small, then a_big b_big, into the same f32
// accumulator.  The dropped a_small b_small is below 2^-20 |a b| and the cut
// small below 2^-20 |x|, so a sum keeps f32 accuracy where one TF32 product
// alone would not.  Tiles live in shared memory in f32 with rows padded to d +
// 4 floats (d % 8 == 0): K-major fragments come by ldmatrix, whose 8 rows
// then fall in 8 distinct 16-byte bank groups, and the MN-major fragments of
// grads_3xtf32 by scalar loads, a warp's in 32 distinct banks.  Global tiles
// come by cp.async, 16 bytes a copy, so the tensors are 16-byte aligned.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {
// Fragment elements split as x = big + small.  The tensor cores read the top
// 19 bits of a TF32 operand (sign, exponent, 10 mantissa bits) and ignore the
// rest, so x itself serves as big (x cut toward zero to TF32), and small = x -
// big, exact in f32, is cut in turn: |small| < 2^-10 |x|, and big + the cut
// small lies within 2^-20 |x| of x.  Two operations an element, one fewer
// than rounding big to nearest.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// A fragment of m16n8k8: (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.big[0], f.small[0]);
  split_tf32(a1, f.big[1], f.small[1]);
  split_tf32(a2, f.big[2], f.small[2]);
  split_tf32(a3, f.big[3], f.small[3]);
  return f;
}

// B fragment of m16n8k8: (k t, column g), (t + 4, g)
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.big[0], f.small[0]);
  split_tf32(b1, f.big[1], f.small[1]);
  return f;
}

// Four 8-row x 4-float blocks of a float32 tile (four 8x8 b16 matrices to
// ldmatrix): lane i gives the address of row i % 8 of block i / 8 and
// receives element (row i / 4, column i % 4) of each block, the (g, t)
// element of a K-major tf32 fragment.  Rows 16-byte aligned.
__device__ __forceinline__ void ldsm4(float (&r)[4], const float* p) {
  uint32_t x[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(sm90::smem_u32(p)));
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(x[i]);
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two cross terms first, then big x big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// 16 (or 4) bytes global -> shared without the registers; zeros where !ok,
// and then the source is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0 .. row0 + R - 1 of a (rows, d) float32 matrix into a shared tile
// of row stride ld, zeros past the last row, by NT threads.
template <int R, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows,
                                          int d, int ld) {
  const int vecs = d / 4;
  for (int i = threadIdx.x; i < R * vecs; i += NT) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 4;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * ld + c, src + static_cast<size_t>(ok ? row0 + r : 0) * d + c, ok);
  }
}

// Values row0 .. row0 + R - 1 of a float32 row vector, zeros past `rows`.
template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int rows) {
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    const bool ok = row0 + i < rows;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// One 8-wide depth step of acc[n] += A B^T: A the 16 rows at a, B^T the 8 NS
// rows at b (n-tile n: rows 8n .. 8n + 7), both K-major at row stride ld,
// a and b already at this lane's ldmatrix address for the step; NS even.
template <int NS>
__device__ __forceinline__ void score_step(float (&acc)[NS][4], const float* a, const float* b,
                                           int ld) {
  float x[4];
  ldsm4(x, a);  // blocks: rows 0-7 | 8-15 at columns 0-3, then at 4-7
  const FragA fa = split_a(x[0], x[1], x[2], x[3]);
  static_assert(NS % 2 == 0, "ldmatrix loads two n-tiles at once");
#pragma unroll
  for (int n = 0; n < NS; n += 2) {
    ldsm4(x, b + 8 * n * ld);  // blocks: n-tile n at columns 0-3 | 4-7, then n + 1
    mma_3xtf32(acc[n], fa, split_b(x[0], x[1]));
    mma_3xtf32(acc[n + 1], fa, split_b(x[2], x[3]));
  }
}

// This lane's ldmatrix offsets (floats) into a K-major A tile and B^T tile.
__device__ __forceinline__ int ldsm_a_offset(int lane, int ld) {
  return (8 * (lane / 8 % 2) + lane % 8) * ld + 4 * (lane / 16);
}
__device__ __forceinline__ int ldsm_b_offset(int lane, int ld) {
  return (8 * (lane / 16) + lane % 8) * ld + 4 * (lane / 8 % 2);
}

// acc[n] += A B^T over the d columns (see score_step).
template <int NS>
__device__ __forceinline__ void scores_3xtf32(float (&acc)[NS][4], const float* a,
                                              const float* b, int ld, int d, int lane) {
  a += ldsm_a_offset(lane, ld);
  b += ldsm_b_offset(lane, ld);
#pragma unroll 2
  for (int kk = 0; kk < d; kk += 8) score_step<NS>(acc, a + kk, b + kk, ld);
}

// Two such products in one loop: s[n] += A0 B0^T and dp[n] += A1 B1^T,
// the depth loop unrolled U times.
template <int NS, int U>
__device__ __forceinline__ void scores2_3xtf32(float (&s)[NS][4], const float* a0,
                                               const float* b0, float (&dp)[NS][4],
                                               const float* a1, const float* b1, int ld, int d,
                                               int lane) {
  const int ao = ldsm_a_offset(lane, ld);
  const int bo = ldsm_b_offset(lane, ld);
#pragma unroll U
  for (int kk = 0; kk < d; kk += 8) {
    score_step<NS>(s, a0 + ao + kk, b0 + bo + kk, ld);
    score_step<NS>(dp, a1 + ao + kk, b1 + bo + kk, ld);
  }
}

// acc[c] += A B: A (16 x 8 NS) in the accumulator layout of scores_3xtf32
// (row g: columns 8n + 2t, 8n + 2t + 1), B the 8 NS rows of `b` (row stride
// ld), output columns 8c .. 8c + 7 for 8c < d.  The contraction slots of each
// 8-wide slice are permuted, the same way for A and B: k index t takes
// element 2t and t + 4 takes 2t + 1, so A is the accumulator as it lies.
template <int NS, int NO>
__device__ __forceinline__ void grads_3xtf32(float (&acc)[NO][4], const float (&a)[NS][4],
                                             const float* b, int ld, int d, int g, int t) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const FragA fa = split_a(a[n][0], a[n][2], a[n][1], a[n][3]);
    const float* bn = b + (8 * n + 2 * t) * ld + g;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      if (8 * c < d) mma_3xtf32(acc[c], fa, split_b(bn[8 * c], bn[8 * c + ld]));
  }
}

// acc * s (16 rows x d, accumulator layout) into rows row0 + g (+ 8) < rows
// of a (rows, d) float32 matrix.
template <int NO>
__device__ __forceinline__ void store_frag_rows(float* out, const float (&acc)[NO][4], int row0,
                                                int rows, int d, int g, int t, float s) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= rows) continue;
    float* base = out + static_cast<size_t>(row) * d + 2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      if (8 * c < d)
        *reinterpret_cast<float2*>(base + 8 * c) =
            make_float2(acc[c][2 * h] * s, acc[c][2 * h + 1] * s);
  }
}

}  // namespace
