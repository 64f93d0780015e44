// Probe of the attention-dropout keep-mask: writes one logical tile's mask.
//
// Replaces: imagined_speech_translation_tpu's tools/tpu_kernel_check.py:
// _mask_kernel, the minimal Pallas kernel that dumps _tile_keep_mask
// (ops/pallas_attention.py) for one (bh, q-tile, k-tile) as float32 so a
// check can gate the keep fraction.  Here it runs the same __device__ mask
// function (dropout_mask.cuh) that the flash forward and backward kernels
// call, so comparing its output with the plain mask bit for bit checks the
// masks those kernels apply.
//
// What bounds it: the bytes it writes (4 per element; 0.5 MB for a
// (256, 512) tile) and, far below that, ~12 integer operations per element.
// One thread per element, consecutive threads on consecutive columns.

#include <cuda_runtime.h>

#include "dropout_mask.cuh"

namespace {

__global__ void dropout_mask_kernel(float* __restrict__ out, DropoutMask m, int bh, int q0,
                                    int k0) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = m.block_q * m.block_k;
  if (idx >= n) return;
  const int r = idx / m.block_k;
  const int c = idx - r * m.block_k;
  out[idx] = dropout_keep(m, bh, q0 + r, k0 + c) ? 1.f : 0.f;
}

}  // namespace

extern "C" {

// out: float32 (block_q, block_k) on the device: 1 where the element of tile
// (qi, ki) of head bh is kept, 0 where it is dropped.  Returns the
// cudaError_t of the launch.
int ist_dropout_mask(float* out, int bh, int qi, int ki, int block_q, int block_k, int seed,
                     unsigned threshold, void* stream) {
  if (bh < 0 || qi < 0 || ki < 0 || block_q < 1 || block_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DropoutMask m = make_dropout_mask(1, seed, threshold, block_q, block_k, 1.f);
  const int n = block_q * block_k;
  dropout_mask_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, m, bh, qi * block_q, ki * block_k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
