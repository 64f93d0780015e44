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
//
// Under data parallelism a rank launches on its own rows of the batch, so its
// local head index is not the head the single-device run would give the same
// scores.  The heads of a launch are (r, b, h) flattened, with r a leading
// fold (the four regions of the region encoders, 1 elsewhere), b one of the
// rank's b_local rows and h one of `heads`; the mask is drawn for the global
// head (r * b_global + b_offset + b) * heads + h (dropout_global_head).
// b_local == b_global is the identity (one device), the default.  The kernels
// take the mapping as a template flag (kMap) and launch the mapped
// instantiation only for a mapped mask (dropout_mapped): with kMap false,
// dropout_keep and dropout_tile_base are the unmapped code, so a launch on one
// device runs the same instructions, registers and bits as without the
// mapping; with kMap true they map the head at each call, which holds no
// register across a kernel's loop.

#pragma once

#include <cstdint>

struct DropoutMask {
  uint32_t seed_mix;   // 0x85EBCA6B * uint32(seed)
  uint32_t threshold;  // keep iff bits >= threshold = round(rate * 2^32)
  int block_q;
  int block_k;
  float inv_keep;  // 1 / (1 - rate)
  bool on;         // rate > 0
  int b_local;     // batch rows of this launch
  int b_global;    // batch rows of the single-device launch
  int b_offset;    // this launch's first row among them
  int heads;       // heads per batch row
};

inline DropoutMask make_dropout_mask(int on, int seed, unsigned threshold, int block_q,
                                     int block_k, float inv_keep, int b_local = 1,
                                     int b_global = 1, int b_offset = 0, int heads = 1) {
  DropoutMask m;
  m.seed_mix = 0x85EBCA6Bu * static_cast<uint32_t>(seed);
  m.threshold = threshold;
  m.block_q = block_q;
  m.block_k = block_k;
  m.inv_keep = inv_keep;
  m.on = on != 0;
  m.b_local = b_local;
  m.b_global = b_global;
  m.b_offset = b_offset;
  m.heads = heads;
  return m;
}

// Whether a launch of bh heads (0: any) can carry this head mapping: its
// heads are whole (fold, b_local, heads) blocks and its rows lie inside the
// global batch.
inline bool dropout_heads_valid(int bh, int b_local, int b_global, int b_offset, int heads) {
  if (b_local == b_global) return b_offset == 0;
  return heads >= 1 && b_local >= 1 && b_offset >= 0 && b_offset + b_local <= b_global &&
         bh % (b_local * heads) == 0;
}

// Whether a launch runs the mapped (kMap) instantiation of its kernel.
inline bool dropout_mapped(const DropoutMask& m) { return m.on && m.b_local != m.b_global; }

// The head of the single-device launch whose mask local head bh draws.
__device__ __forceinline__ uint32_t dropout_global_head(const DropoutMask& m, int bh) {
  if (m.b_local == m.b_global) return static_cast<uint32_t>(bh);
  const int rb = bh / m.heads;
  const int h = bh - rb * m.heads;
  const int r = rb / m.b_local;
  const int b = rb - r * m.b_local;
  return static_cast<uint32_t>((r * m.b_global + m.b_offset + b) * m.heads + h);
}

// The hash's finaliser, applied to index + 0x9E3779B9 * tile_id + seed_mix.
__device__ __forceinline__ uint32_t dropout_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t dropout_hash(uint32_t seed_mix, uint32_t tile_id,
                                                 uint32_t index) {
  return dropout_mix(index + 0x9E3779B9u * tile_id + seed_mix);
}

// The keep bit of element (row, col) of head bh: of the launch's head bh
// mapped to its global head with kMap, of head bh itself without.
template <bool kMap = false>
__device__ __forceinline__ bool dropout_keep(const DropoutMask& m, int bh, int row, int col) {
  const uint32_t qi = static_cast<uint32_t>(row / m.block_q);
  const uint32_t ki = static_cast<uint32_t>(col / m.block_k);
  const uint32_t head = kMap ? dropout_global_head(m, bh) : static_cast<uint32_t>(bh);
  const uint32_t tile_id = (head * 256u + qi) * 256u + ki;
  const uint32_t index = static_cast<uint32_t>(row - static_cast<int>(qi) * m.block_q) *
                             static_cast<uint32_t>(m.block_k) +
                         static_cast<uint32_t>(col - static_cast<int>(ki) * m.block_k);
  return dropout_hash(m.seed_mix, tile_id, index) >= m.threshold;
}

// The same bits with the division hoisted out of a kernel tile that lies
// inside one logical tile (its first row and column, row0 and col0, are
// multiples of tiles that divide block_q and block_k): dropout_keep(m, bh,
// row0 + r, col0 + c) == dropout_keep_at(m, dropout_tile_base(m, bh, row0,
// col0), r * block_k + c), by the wrapping arithmetic of the hash's input.
template <bool kMap = false>
__device__ __forceinline__ uint32_t dropout_tile_base(const DropoutMask& m, int bh, int row0,
                                                      int col0) {
  const uint32_t qi = static_cast<uint32_t>(row0 / m.block_q);
  const uint32_t ki = static_cast<uint32_t>(col0 / m.block_k);
  const uint32_t head = kMap ? dropout_global_head(m, bh) : static_cast<uint32_t>(bh);
  const uint32_t tile_id = (head * 256u + qi) * 256u + ki;
  const uint32_t index = static_cast<uint32_t>(row0 - static_cast<int>(qi) * m.block_q) *
                             static_cast<uint32_t>(m.block_k) +
                         static_cast<uint32_t>(col0 - static_cast<int>(ki) * m.block_k);
  return index + 0x9E3779B9u * tile_id + m.seed_mix;
}

__device__ __forceinline__ bool dropout_keep_at(const DropoutMask& m, uint32_t base,
                                                uint32_t offset) {
  return dropout_mix(base + offset) >= m.threshold;
}
