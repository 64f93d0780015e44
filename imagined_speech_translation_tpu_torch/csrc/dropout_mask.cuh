// The attention-dropout keep-mask, shared by the flash forward, the fused
// flash backward and the mask probe kernel.
//
// Replaces: imagined_speech_translation_tpu/ops/pallas_attention.py:
// _tile_keep_mask + _hash_bits, the portable counter hash the JAX kernels
// draw their masks from in interpret mode and that the host oracle
// dropout_keep_mask_reference rebuilds.  The port draws the same bits, so its
// masks equal the oracle's bit for bit.  (On the TPU the kernels use the
// hardware PRNG instead: other bits, keep rate 26/256 at rate 0.1.)
//
// An element (bh, row, col) of the (s_q, s_kv) score matrix of head bh lies
// in the LOGICAL tile (qi, ki) = (row / block_q, col / block_k), where
// block_q/block_k are the tile sizes flash_attention picks, not this card's
// kernel tiles; that keeps the mask a function of the element alone, so any
// kernel tiling regenerates it.  Inside the tile its index is
// (row % block_q) * block_k + col % block_k.  All arithmetic is unsigned
// 32-bit and wraps, as the uint32 hash does.

#pragma once

#include <cstdint>

struct DropoutMask {
  uint32_t seed_mix;   // 0x85EBCA6B * uint32(seed)
  uint32_t threshold;  // keep iff bits >= threshold = round(rate * 2^32)
  int block_q;
  int block_k;
  float inv_keep;  // 1 / (1 - rate)
  bool on;         // rate > 0
};

inline DropoutMask make_dropout_mask(int on, int seed, unsigned threshold, int block_q,
                                     int block_k, float inv_keep) {
  DropoutMask m;
  m.seed_mix = 0x85EBCA6Bu * static_cast<uint32_t>(seed);
  m.threshold = threshold;
  m.block_q = block_q;
  m.block_k = block_k;
  m.inv_keep = inv_keep;
  m.on = on != 0;
  return m;
}

__device__ __forceinline__ uint32_t dropout_hash(uint32_t seed_mix, uint32_t tile_id,
                                                 uint32_t index) {
  uint32_t x = index + 0x9E3779B9u * tile_id + seed_mix;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool dropout_keep(const DropoutMask& m, int bh, int row, int col) {
  const uint32_t qi = static_cast<uint32_t>(row / m.block_q);
  const uint32_t ki = static_cast<uint32_t>(col / m.block_k);
  const uint32_t tile_id = (static_cast<uint32_t>(bh) * 256u + qi) * 256u + ki;
  const uint32_t index = static_cast<uint32_t>(row - static_cast<int>(qi) * m.block_q) *
                             static_cast<uint32_t>(m.block_k) +
                         static_cast<uint32_t>(col - static_cast<int>(ki) * m.block_k);
  return dropout_hash(m.seed_mix, tile_id, index) >= m.threshold;
}
