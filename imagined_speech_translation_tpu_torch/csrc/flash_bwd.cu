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
// (2.5x the forward; 0.340 ms at both training shapes, (96, 1655, 128) and
// (48, 1655, 256), at the bf16 tensor-core peak of 989 TFLOP/s) against ~8
// bytes per (row, dim) per tensor moved, plus ~10 integer operations per
// score element for the mask.
//
// Design.  The TPU kernel runs its grid in order and keeps dQ resident in
// VMEM across the sequential k axis.  Blocks on the card run in no order, so
// here each block owns one (bh, key tile), loops over the query tiles and
// adds its share of dQ by float32 atomic reductions: the key-tile backward of
// flash_bwd_kv.cuh with kDQ on, which describes both variants.  In bf16 (the
// training path) it is built for Hopper: two consumer warpgroups with dK/dV
// in registers, wgmma with P~^T and dS^T as register operands, a producer
// warp feeding Q/dO/lse/delta tiles through a TMA ring, dQ by wgmma and
// 4-float vector reductions, and the mask's hash input hoisted per tile; it
// replaces an mma.sync version whose four warps kept dK/dV in shared memory,
// staged P~ and dS through it, loaded synchronously and added dQ by scalar
// atomics.  In f32 it runs on the CUDA cores.

#include "flash_bwd_kv.cuh"

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
  return key_tile_backward<true>(q, k, v, dout, lse, delta, dq, dk, dv, bh, s_q, s_kv, d, qscale,
                                 scale, dtype, drop, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
