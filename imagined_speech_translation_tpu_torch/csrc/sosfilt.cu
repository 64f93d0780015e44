// Cascaded second-order-section IIR filter (transposed direct form II),
// zero initial state, float32.
//
// Replaces: imagined_speech_translation_tpu/frontend/filters.py:_sos_kernel
// (called by sosfilt_pallas): the fused 4-section Butterworth bandpass plus
// 1-section notch that the serving path runs on every raw window.
//
// What bounds it on an H100: the recurrence is sequential in time, so each
// series is one dependent chain of ~3 FMAs per section per sample (about 15
// dependent FMAs per sample for 5 sections).  The data is small (2000 series
// x 1651 samples x 4 B, read once and written once, ~26 MB at batch 16), so
// the kernel is latency bound: the chain per thread, and the load latency of
// each sample.
//
// Design: one thread per series, all section states in registers, one pass
// over time.  The data is laid out (T, series) -- the TPU kernel's own layout
// -- so the 32 threads of a warp read and write 32 neighbouring floats at each
// time step (coalesced).  Samples are loaded in chunks of 8 before the chain
// runs over them, so the loads of a chunk are in flight together instead of
// one dependent load per step.  Coefficients arrive by value in the kernel's
// parameter space (constant bank), already divided by a0 on the host in
// float64 and cast to float32, as the TPU wrapper does.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxSections = 8;
constexpr int kThreads = 64;
constexpr int kChunk = 8;

struct SosCoeffs {
  float c[kMaxSections][5];  // b0, b1, b2, a1, a2 (all divided by a0)
};

__device__ __forceinline__ float cascade(float v, float (&z1)[kMaxSections],
                                         float (&z2)[kMaxSections],
                                         const SosCoeffs& k, int n_sections) {
#pragma unroll
  for (int s = 0; s < kMaxSections; ++s) {
    if (s < n_sections) {
      const float out = k.c[s][0] * v + z1[s];
      z1[s] = k.c[s][1] * v - k.c[s][3] * out + z2[s];
      z2[s] = k.c[s][2] * v - k.c[s][4] * out;
      v = out;
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    sosfilt_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int n_series, int t_len, int n_sections, SosCoeffs k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_series) return;
  float z1[kMaxSections], z2[kMaxSections];
#pragma unroll
  for (int s = 0; s < kMaxSections; ++s) {
    z1[s] = 0.f;
    z2[s] = 0.f;
  }
  const size_t stride = static_cast<size_t>(n_series);
  const float* xp = x + i;
  float* yp = y + i;
  int t = 0;
  for (; t + kChunk <= t_len; t += kChunk) {
    float buf[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) buf[u] = xp[(t + u) * stride];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) buf[u] = cascade(buf[u], z1, z2, k, n_sections);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) yp[(t + u) * stride] = buf[u];
  }
  for (; t < t_len; ++t) {
    yp[t * stride] = cascade(xp[t * stride], z1, z2, k, n_sections);
  }
}

}  // namespace

extern "C" {

// x, y: device float32 (t_len, n_series), row-major.  coeffs: HOST float32
// (n_sections, 5) = b0, b1, b2, a1, a2.  Returns the cudaError_t of the launch.
int ist_sosfilt_f32(const float* x, float* y, int n_series, int t_len,
                    const float* coeffs, int n_sections, void* stream) {
  if (n_series < 1 || t_len < 1 || n_sections < 1 || n_sections > kMaxSections) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SosCoeffs k;
  std::memset(&k, 0, sizeof(k));
  std::memcpy(k.c, coeffs, sizeof(float) * 5 * n_sections);
  const int blocks = (n_series + kThreads - 1) / kThreads;
  sosfilt_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n_series, t_len, n_sections, k);
  return static_cast<int>(cudaGetLastError());
}

int ist_sosfilt_max_sections() { return kMaxSections; }

const char* ist_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
