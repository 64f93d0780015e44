// The float32 key-tile attention backward on the tensor cores in 3xTF32,
// shared by the split dK/dV kernel (flash_bwd_split.cu: rate 0, without dQ)
// and the fused backward (flash_bwd.cu: rate > 0, with dQ and the dropout
// mask): one template, flash_bwd_tf32_kernel, with a dQ flag and a dropout
// flag.  Float32 with d % 8 == 0 and 16-byte aligned tensors; other d keep
// the CUDA-core variant of flash_bwd_kv.cuh.
//
// Given q, k, v, dO (float32, (bh, S, d)), the forward's base-2 lse and
// delta = rowsum(dO * O), each block owns one (bh, tile of 16 NG keys), keeps
// K, V and its dK/dV sums on chip and loops over the query tiles:
//
//   dV = P~^T dO,   dS = P * (M / (1 - rate) * dP - delta),   dP = dO V^T
//   dK = scale * dS^T Q,   dQ = scale * dS K  (kDQ only)
//
// with P = exp2(S * qscale - lse), P~ = M / (1 - rate) * P and M the keep mask
// of dropout_mask.cuh (all ones without kDrop).  Keys >= s_kv score -1e30 (P
// = 0) against zero K/V rows; queries >= s_q read zero lse, delta and rows
// and contribute nothing.  dK and dV are each block's own rows, written once:
// two launches give the same bits.  With kDQ the block adds its dQ partial
// into a float32 (bh, s_q, d) buffer, zeroed by the caller, by 4-float vector
// reductions; their order, and so dQ's last bits, vary from launch to launch.
//
// What bounds it on an H100: arithmetic, 10 * bh * s_q * s_kv * d FLOPs for
// the fused backward (8 for dK/dV alone), at 165 TFLOP/s, the rate of
// f32-accurate products by 3xTF32 (495 TFLOP/s TF32 / 3): 2.040 ms at both
// training shapes, (96, 1655, 128) and (48, 1655, 256).  What held the
// CUDA-core fused kernel before it back (18.603 and 30.839 ms there, on an
// H100 at 700 W): f32 FMAs peak at 67 TFLOP/s; 256 threads as 16 x 16 fed
// them with scalar shared-memory loads, kept every tile (P~ and dS included)
// in shared memory and loaded synchronously; dQ went out by scalar atomics.
// It reached 11% and 7% of the bound.  What this design does:
//
// * Products: mma.sync m16n8k8 in 3xTF32 by the helpers of tf32.cuh (each
//   operand split into big and small in registers; one TF32 pass alone
//   misses the 1e-4 bound).  S^T = K Q^T and dP^T = V dO^T with 16 keys a
//   warp as M, so P~^T and dS^T come out in the accumulator layout and feed
//   dV += P~^T dO and dK += dS^T Q as the A operand as they lie (the
//   contraction slots permuted, B read at rows 2t and 2t + 1).
// * Warp pairs: warps w and w + NG share keys 16w .. 16w + 15; w computes
//   S^T, P~^T and dV, w + NG dP^T, dS^T and dK, so one sum a warp stays in
//   registers for the whole query loop.  P passes from w to w + NG through a
//   shared buffer of the pair (a named barrier), in f32 with the keep bit in
//   its sign: P >= 0, so -P (-0.0 for a dropped zero) marks a dropped
//   element and the hash runs once per element, in w.
// * The mask: where the pair's 16-key x BQ-query slice lies inside one
//   logical tile (block_q % BQ == 0, block_k % 16 == 0; the f32 training
//   shapes' 256 x 256 tiles) the hash input is hoisted to the slice
//   (dropout_tile_base) and each element costs only the finaliser; other
//   logical tiles keep dropout_keep's two divisions per element.  Both give
//   the same bits.
// * dQ: warp w + NG overwrites the P it read with dS^T, in place (same lane,
//   same slot, so no warp waits for another), in a layout whose slot index
//   is XOR-swizzled by 4 on odd accumulator elements: then after one block
//   barrier every warp reads dS (BQ queries x 16 NG keys) straight from it as
//   the A operand of dQ = dS K, 4 conflict-free scalar loads a fragment, and
//   K from the block's own tile.  Each warp takes all BQ queries and its own
//   range of d's 8-column n-tiles (NQ at a time, so the partial fits beside
//   the dK/dV sum); it adds the partial, scaled, into dQ: neighbouring lanes
//   swap half their pairs so each adds 4 consecutive floats with one
//   red.global.add.v4.f32 (sm_90's float4 atomicAdd with the result
//   unused), never scalar atomics.  Blocks start their query loops at
//   different tiles (by key tile) so their reductions spread over the rows.
// * Copies: K and V once, then per query tile Q, dO, lse and delta by
//   cp.async (16 bytes a copy, zeros past the last row) into rows padded to
//   d + 4 floats (ldmatrix and the scalar B loads without bank conflicts).
//
// Shared memory (floats): K, V (16 NG x (d + 4) each), one stage of Q, dO
// (BQ x (d + 4) each), lse, delta (BQ each), then the pairs' buffers (16 NG
// x BQ).  The dispatched shapes, their registers and the times of the
// alternatives (cli/tune_split_bwd.py --program bwd_tf32) are noted at the
// dispatch in flash_bwd.cu and flash_bwd_split.cu.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_mask.cuh"
#include "flash_bwd_kv.cuh"
#include "tf32.cuh"

namespace {

template <int NG, int BQ>
struct BwdTf32 {
  static constexpr int NT = 64 * NG;   // threads: NG warp pairs
  static constexpr int BKK = 16 * NG;  // keys a block
  static size_t smem_bytes(int d) {
    return sizeof(float) * (static_cast<size_t>(2 * BKK + 2 * BQ) * (d + 4) + 2 * BQ + BKK * BQ);
  }
};

// Where accumulator element e of n-tile n of lane `lane` lies in a pair's
// buffer; with kDQ the lane index is swizzled so the dQ product's fragment
// loads (dq_partial) hit 32 distinct banks.
template <bool kDQ>
__device__ __forceinline__ int pair_slot(int n, int e, int lane) {
  return (4 * n + e) * 32 + (kDQ && (e & 1) ? lane ^ 4 : lane);
}

// acc * scale (16 query rows from row0, NQ n-tiles of 8 columns from col0,
// accumulator layout) added into the float32 dQ rows of one head: even lanes
// add 4 columns of row g, odd lanes 4 of row g + 8, each by one vector
// reduction.
template <int NQ>
__device__ __forceinline__ void red_dq(float* dq_head, const float (&acc)[NQ][4], int row0,
                                       int col0, int s_q, int d, int g, int t, float scale) {
  const bool even = t % 2 == 0;
  const int row = row0 + g + (even ? 0 : 8);
  float* base = dq_head + static_cast<size_t>(row) * d;
#pragma unroll
  for (int c = 0; c < NQ; ++c) {
    const float s0 = even ? acc[c][2] : acc[c][0];
    const float s1 = even ? acc[c][3] : acc[c][1];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const int col = col0 + 8 * c + 2 * (t & ~1);
    const float4 v = even ? make_float4(acc[c][0], acc[c][1], r0, r1)
                          : make_float4(r0, r1, acc[c][2], acc[c][3]);
    if (row < s_q && col < d) {
      atomicAdd(reinterpret_cast<float4*>(base + col),
                make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale));
    }
  }
}

// The keep bits of a pair's 16-key x 8 NS-query slice (keys key0 .., queries
// q0 ..) for this lane: bit 4 n + e for accumulator element e of n-tile n
// (key key0 + g + 8 (e / 2), query q0 + 8 n + 2 t + e % 2).  Where the slice
// lies inside one logical tile the hash input is hoisted to it; otherwise
// each element divides.  Both give dropout_keep's bits.
template <int NS, bool kMap>
__device__ __forceinline__ uint32_t pair_keep_bits(const DropoutMask& m, bool hoist, int bh,
                                                   int q0, int key0, int g, int t) {
  static_assert(NS <= 8, "one bit a lane's element in 32 bits");
  uint32_t bits = 0;
  // rolled loops: the hashes of 16 elements in flight at once would take the
  // registers the dK/dV sum needs
  if (hoist) {
    const uint32_t bk = static_cast<uint32_t>(m.block_k);
    const uint32_t base = dropout_tile_base<kMap>(m, bh, q0, key0) +
                          static_cast<uint32_t>(2 * t) * bk +
                          static_cast<uint32_t>(g);
#pragma unroll 4
    for (int j = 0; j < 4 * NS; ++j) {
      const uint32_t off = static_cast<uint32_t>(8 * (j / 4) + (j & 1)) * bk + 8 * ((j / 2) % 2);
      bits |= static_cast<uint32_t>(dropout_keep_at(m, base, off)) << j;
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < 4 * NS; ++j)
      bits |= static_cast<uint32_t>(dropout_keep<kMap>(m, bh, q0 + 8 * (j / 4) + 2 * t + (j & 1),
                                                       key0 + g + 8 * ((j / 2) % 2)))
              << j;
  }
  return bits;
}

// dQ's partial of this block's keys, dS (BQ queries x 16 NG keys, the pairs'
// dS^T buffers) times K (the block's key tile, row stride ld), for this
// warp's n-tiles, NQ at a time, with the A fragments of MTB m-tiles in
// registers at once and the loop over 8-key slices unrolled KU times, added
// into the dQ rows q0 .. of one head.
template <int DMAX, int BQ, int NG, int NQ, int MTB, int KU>
__device__ __forceinline__ void dq_partial(float* dq_head, const float* pbufs, const float* ks,
                                           int ld, int d, int q0, int s_q, int warp, int g, int t,
                                           float scale) {
  constexpr int MT = BQ / 16;                                // m-tiles of 16 queries
  constexpr int NQT = (DMAX / 8 + 2 * NG - 1) / (2 * NG);  // n-tiles a warp
  static_assert(NQT % NQ == 0 && MT % MTB == 0, "a warp's n-tiles in passes of NQ");
  // this lane's slots in a pair buffer: element 2 hh + g % 2 of n-tiles 2 mt
  // (+ 1 for rows g + 8), lanes 8 t + g / 2 (keys 2t) and + 4 (keys 2t + 1)
  const int odd = g & 1;
  const int l0 = (8 * t + g / 2) ^ (4 * odd);
  const int l1 = (8 * t + 4 + g / 2) ^ (4 * odd);
#pragma unroll
  for (int pass = 0; pass < NQT / NQ; ++pass) {
    const int c0 = warp * NQT + pass * NQ;
    if (8 * c0 >= d) break;
    float acc[MT][NQ][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < NQ; ++c)
        acc[mt][c][0] = acc[mt][c][1] = acc[mt][c][2] = acc[mt][c][3] = 0.f;
#pragma unroll KU
    for (int kk = 0; kk < 2 * NG; ++kk) {  // 8-key slices: pair kk / 2, half kk % 2
      const float* src = pbufs + (kk / 2) * 16 * BQ + (2 * (kk % 2) + odd) * 32;
      const float* kb = ks + (8 * kk + 2 * t) * ld + g;
#pragma unroll
      for (int m0 = 0; m0 < MT; m0 += MTB) {
        FragA fa[MTB];
#pragma unroll
        for (int m = 0; m < MTB; ++m) {
          const float* s = src + 8 * (m0 + m) * 32;
          fa[m] = split_a(s[l0], s[128 + l0], s[l1], s[128 + l1]);
        }
#pragma unroll
        for (int c = 0; c < NQ; ++c) {
          const int col = 8 * (c0 + c);
          if (col < d) {
            const FragB fb = split_b(kb[col], kb[col + ld]);
#pragma unroll
            for (int m = 0; m < MTB; ++m) mma_3xtf32(acc[m0 + m][c], fa[m], fb);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      red_dq<NQ>(dq_head, acc[mt], q0 + 16 * mt, 8 * c0, s_q, d, g, t, scale);
  }
}

template <int DMAX, int BQ, int NG, int MINB, int NQ, int MTB, int KU, bool kDQ, bool kDrop,
          bool kMap>
__global__ void __launch_bounds__(64 * NG, MINB)
    flash_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                          int s_q, int s_kv, int d, float qscale, float scale, DropoutMask drop) {
  using L = BwdTf32<NG, BQ>;
  constexpr int NT = L::NT;
  constexpr int BKK = L::BKK;
  constexpr int NS = BQ / 8;    // score n-tiles of 8 queries
  constexpr int NO = DMAX / 8;  // output n-tiles of 8 dims
  extern __shared__ __align__(16) float smem_f[];
  const int ld = d + 4;
  float* ks = smem_f;
  float* vs = ks + BKK * ld;
  float* qs = vs + BKK * ld;
  float* dos = qs + BQ * ld;
  float* lse_s = dos + BQ * ld;
  float* delta_s = lse_s + BQ;
  float* pbufs = delta_s + BQ;  // the pairs' P^T (sign: dropped), then dS^T
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int grp = warp % NG;       // this warp's 16 keys: 16 grp ..
  const bool dv_warp = warp < NG;  // S^T, P~^T, dV; else dP^T, dS^T, dK
  float* pbuf = pbufs + grp * 16 * BQ;
  const int k0 = blockIdx.x * BKK;
  const int bh = blockIdx.y;
  const float* qb = q + static_cast<size_t>(bh) * s_q * d;
  const float* db = dout + static_cast<size_t>(bh) * s_q * d;
  const float* lb = lse + static_cast<size_t>(bh) * s_q;
  const float* deb = delta + static_cast<size_t>(bh) * s_q;
  const int n_qt = (s_q + BQ - 1) / BQ;
  // with dQ, blocks start apart so their reductions spread over the rows
  // (without, the loop is the plain q0 = 0, BQ, ..: `it` is dead)
  const int first = kDQ ? blockIdx.x % n_qt : 0;

  auto load_tile = [&](int q0) {
    load_rows<BQ, NT>(qs, qb, q0, s_q, d, ld);
    load_rows<BQ, NT>(dos, db, q0, s_q, d, ld);
    load_vec<BQ>(lse_s, lb, q0, s_q);
    load_vec<BQ>(delta_s, deb, q0, s_q);
  };
  load_rows<BKK, NT>(ks, k + static_cast<size_t>(bh) * s_kv * d, k0, s_kv, d, ld);
  load_rows<BKK, NT>(vs, v + static_cast<size_t>(bh) * s_kv * d, k0, s_kv, d, ld);
  load_tile(first * BQ);
  cp_async_commit();

  float acc[NO][4];  // dV or dK
#pragma unroll
  for (int c = 0; c < NO; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  const int key_lo = k0 + 16 * grp + g;  // this thread's keys: key_lo (e = 0, 1), + 8 (2, 3)
  // the pair's 16-key x BQ-query slice lies inside one logical dropout tile
  const bool hoist = kDrop && drop.block_q % BQ == 0 && drop.block_k % 16 == 0;
  for (int it = 0, q0 = first * BQ; kDQ ? it < n_qt : q0 < s_q;
       ++it, q0 = kDQ && q0 + BQ >= s_q ? 0 : q0 + BQ) {
    if (kDQ ? it > 0 : q0 > 0) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile(q0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // this tile has landed

    float x[NS][4];  // S^T, then P~^T; or dP^T, then dS^T
#pragma unroll
    for (int n = 0; n < NS; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
    if (dv_warp) {
      scores_3xtf32<NS>(x, ks + 16 * grp * ld, qs, ld, d, lane);
      // after the product: a word live through it costs the register its
      // peak lacks at two blocks an SM
      uint32_t keep = ~0u;
      if constexpr (kDrop)
        keep = pair_keep_bits<NS, kMap>(drop, hoist, bh, q0, k0 + 16 * grp, g, t);
      // P^T: keys past s_kv score -1e30, queries past s_q give 0
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          const float p = exp2f((key_lo + 8 * (e >> 1) < s_kv ? x[n][e] * qscale : kNegInf) -
                                lse_s[col]);
          x[n][e] = q0 + col < s_q ? p : 0.f;
          if constexpr (kDrop) {
            const bool kp = (keep >> (4 * n + e)) & 1u;
            pbuf[pair_slot<kDQ>(n, e, lane)] = kp ? x[n][e] : -x[n][e];
            x[n][e] = kp ? x[n][e] * drop.inv_keep : 0.f;
          } else {
            pbuf[pair_slot<kDQ>(n, e, lane)] = x[n][e];  // to warp grp + NG, same lane
          }
        }
      sm90::bar_arrive(1 + grp, 64);
      grads_3xtf32<NS, NO>(acc, x, dos, ld, d, g, t);  // dV += P~^T dO
    } else {
      scores_3xtf32<NS>(x, vs + 16 * grp * ld, dos, ld, d, lane);
      sm90::bar_sync(1 + grp, 64);  // warp grp's P^T of this tile
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = pair_slot<kDQ>(n, e, lane);
          const float y = pbuf[slot];
          float p = y, dp = x[n][e];
          if constexpr (kDrop) {
            p = fabsf(y);
            dp = signbit(y) ? 0.f : dp * drop.inv_keep;
          }
          x[n][e] = p * (dp - delta_s[8 * n + 2 * t + (e & 1)]);
          if constexpr (kDQ) pbuf[slot] = x[n][e];  // dS^T for dQ, where P was
        }
      grads_3xtf32<NS, NO>(acc, x, qs, ld, d, g, t);  // dK += dS^T Q
    }
    if constexpr (kDQ) {
      __syncthreads();  // every pair's dS^T is in its buffer
      dq_partial<DMAX, BQ, NG, NQ, MTB, KU>(dq + static_cast<size_t>(bh) * s_q * d, pbufs, ks, ld,
                                            d, q0, s_q, warp, g, t, scale);
    }
  }
  const size_t out = static_cast<size_t>(bh) * s_kv * d;
  if (dv_warp)
    store_frag_rows<NO>(dv + out, acc, k0 + 16 * grp, s_kv, d, g, t, 1.f);
  else
    store_frag_rows<NO>(dk + out, acc, k0 + 16 * grp, s_kv, d, g, t, scale);
}

// Launches the kernel over (bh, s, d) float32 tensors: with kDQ, dQ's
// reductions into dq and the mask of `drop` where it is on; without, dK and
// dV alone (drop must be off).
template <int DMAX, int BQ, int NG, int MINB, int NQ, int MTB, int KU, bool kDQ>
int launch_bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, float* dq, void* dk, void* dv, int bh,
                    int s_q, int s_kv, int d, float qscale, float scale, const DropoutMask& drop,
                    cudaStream_t stream) {
  using L = BwdTf32<NG, BQ>;
  if (bh > 65535 || (!kDQ && drop.on)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_tf32_kernel<DMAX, BQ, NG, MINB, NQ, MTB, KU, kDQ, false, false>;
  if constexpr (kDQ) {
    if (dropout_mapped(drop))
      kernel = flash_bwd_tf32_kernel<DMAX, BQ, NG, MINB, NQ, MTB, KU, true, true, true>;
    else if (drop.on)
      kernel = flash_bwd_tf32_kernel<DMAX, BQ, NG, MINB, NQ, MTB, KU, true, true, false>;
  }
  const size_t smem = L::smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_kv + L::BKK - 1) / L::BKK, bh);
  kernel<<<grid, L::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, dq, static_cast<float*>(dk),
      static_cast<float*>(dv), s_q, s_kv, d, qscale, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// The split dK/dV kernel: 4 warp pairs (64 keys), BQ queries a tile, MINB
// blocks an SM.
template <int DMAX, int BQ, int MINB>
int launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int bh, int s_q,
                    int s_kv, int d, float qscale, float scale, cudaStream_t stream) {
  const DropoutMask none = make_dropout_mask(0, 0, 0, 0, 0, 1.f);
  return launch_bwd_tf32<DMAX, BQ, 4, MINB, 1, 1, 1, false>(q, k, v, dout, lse, delta, nullptr,
                                                            dk, dv, bh, s_q, s_kv, d, qscale,
                                                            scale, none, stream);
}

// float32 takes the 3xTF32 kernels where d % 8 == 0 and every tensor is
// 16-byte aligned (cp.async copies 16 bytes, dQ adds 16), else the CUDA-core
// ones.
template <typename... P>
bool tf32_fits(int d, P... p) {
  return d % 8 == 0 && (aligned16(p) && ...);
}

}  // namespace
