// Fused attention backward (FlashAttention-2 style) with the dropout mask
// regenerated per tile, over (bh, S, d) tensors in float32 or bfloat16.
//
// Replaces: imagined_speech_translation_tpu/ops/pallas_attention.py:
// _bwd_fused_kernel (called by _bwd_call_fused from _flash_core_bwd), the
// backward of every attention with dropout: in training, every
// region-encoder attention (head dim 128 at heads (6,6,6), 256 for the
// shared cross-scale attention, 1655 tokens, attention dropout 0.1).  Rate 0
// goes to the split kernels of flash_bwd_split.cu, as _flash_core_bwd
// dispatches it.
//
// What bounds it on an H100: arithmetic, 10 * bh * s_q * s_kv * d FLOPs
// (2.5x the forward; at both training shapes, (96, 1655, 128) and (48, 1655,
// 256), 0.340 ms at the bf16 tensor-core peak of 989 TFLOP/s and 2.040 ms in
// float32 at 3xTF32's 165 TFLOP/s) against ~8 bytes per (row, dim) per
// tensor moved, plus ~10 integer operations per score element for the mask.
//
// Design.  The TPU kernel runs its grid in order and keeps dQ resident in
// VMEM across the sequential k axis.  Blocks on the card run in no order, so
// here each block owns one (bh, key tile), loops over the query tiles and
// adds its share of dQ by float32 vector reductions.  Two variants:
//
// * bfloat16 (the mixed-precision training path): the Hopper key-tile
//   backward of flash_bwd_kv.cuh with kDQ on: two consumer warpgroups with
//   dK/dV in registers, wgmma with P~^T and dS^T as register operands, a
//   producer warp feeding Q/dO/lse/delta tiles through a TMA ring, dQ by
//   wgmma and 4-float vector reductions, and the mask's hash input hoisted
//   per tile; it replaced an mma.sync version whose four warps kept dK/dV in
//   shared memory, staged P~ and dS through it, loaded synchronously and
//   added dQ by scalar atomics.
// * float32 with d % 8 == 0 and 16-byte aligned tensors (the f32 training
//   path, TrainingConfig.mixed_precision = False, the reference's own
//   numerics): flash_bwd_tf32_kernel of flash_bwd_tf32.cuh with dQ and the
//   mask, on the tensor cores in 3xTF32; the header's note has the design.
//   It replaced the CUDA-core key-tile kernel (18.603 ms at (96, 1655, 128)
//   and 30.839 ms at (48, 1655, 256), dropout 0.1, on an H100 at 700 W),
//   which other f32 head dims (d % 8 != 0) and unaligned tensors keep.
//   Dispatched shapes: 64 keys a block (4 warp pairs), 32-query tiles; d <=
//   128: two blocks of 8 warps an SM (128 registers, 107.3 KB of shared
//   memory at d = 128), dQ one n-tile a pass for both m-tiles; d = 256: one
//   block (240-247 registers, 203.3 KB), dQ four n-tiles a pass.  ptxas: no
//   spills.  Times of the alternatives, from cli/tune_split_bwd.py --program
//   bwd_tf32 on an H100 at 700 W, dropout 0.1 on 256 x 256 logical tiles: at
//   (96, 1655, 128) 7.63 ms as dispatched (7.38 at rate 0), 7.74 with dQ two
//   n-tiles a pass (spills 24 bytes), 7.77 with one m-tile's fragments at a
//   time, 8.41 with 16-query tiles, 8.27 with 128-key blocks of 16 warps
//   (spills), 10.85 at one block of 8 warps an SM (165 registers); at (48,
//   1655, 256) 10.03 ms as dispatched (9.80 at rate 0), 10.23 with two
//   n-tiles a pass, 12.02 with 16-query tiles.  The split dK/dV kernel alone
//   (rate 0, no dQ) takes 5.53 and 7.89 ms there.  The keep bits are formed
//   after the S^T product: formed before it, the word that holds them was
//   live through the product's register peak, and every two-block variant
//   at d = 128 spilled 20-32 bytes.

#include "flash_bwd_kv.cuh"
#include "flash_bwd_tf32.cuh"

namespace {

int dispatch_bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, float* dq, void* dk, void* dv, int bh,
                      int s_q, int s_kv, int d, float qscale, float scale, const DropoutMask& drop,
                      cudaStream_t st) {
  if (d <= 64)
    return launch_bwd_tf32<64, 32, 4, 2, 1, 2, 2, true>(q, k, v, dout, lse, delta, dq, dk, dv,
                                                        bh, s_q, s_kv, d, qscale, scale, drop, st);
  if (d <= 128)
    return launch_bwd_tf32<128, 32, 4, 2, 1, 2, 2, true>(q, k, v, dout, lse, delta, dq, dk, dv,
                                                         bh, s_q, s_kv, d, qscale, scale, drop,
                                                         st);
  return launch_bwd_tf32<256, 32, 4, 1, 4, 2, 2, true>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                                       s_q, s_kv, d, qscale, scale, drop, st);
}

}  // namespace

extern "C" {

// q, dout: (bh, s_q, d); k, v: (bh, s_kv, d), contiguous on the device in one
// dtype (0 = float32, 1 = bfloat16).  lse, delta: float32 (bh, s_q).  dq:
// float32 (bh, s_q, d), zeroed by the caller, accumulated by atomic
// reductions.  dk, dv: (bh, s_kv, d) in the input dtype, written.  qscale =
// scale * log2(e).
// Dropout as in ist_flash_fwd.  Returns the cudaError_t of the launch.
int ist_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, float* dq, void* dk, void* dv, int bh,
                  int s_q, int s_kv, int d, float qscale, float scale, int dtype, int dropout,
                  int seed, unsigned threshold, int block_q, int block_k, float inv_keep,
                  void* stream) {
  if (bh < 1 || s_q < 1 || s_kv < 1 || d < 1 || d > 256 || (s_kv + 31) / 32 > 65535 ||
      (dropout && (block_q < 1 || block_k < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DropoutMask drop = make_dropout_mask(dropout, seed, threshold, block_q, block_k, inv_keep);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && tf32_fits(d, q, k, v, dout, dq, dk, dv))
    return dispatch_bwd_tf32(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d, qscale,
                             scale, drop, st);
  return key_tile_backward<true>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d, qscale,
                                 scale, dtype, drop, st);
}

}  // extern "C"
