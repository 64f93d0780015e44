// Cascaded second-order-section IIR filter (transposed direct form II),
// zero initial state, float32, as a chunked linear recurrence.
//
// Replaces: imagined_speech_translation_tpu/frontend/filters.py:_sos_kernel
// (called by sosfilt_pallas): the fused 4-section Butterworth bandpass plus
// 1-section notch that the serving path runs on every raw window, over
// (B * 125, 1651) series: 2000 at B = 16, 125 at B = 1.
//
// What bounds it on an H100: bytes.  Each sample is read once and written
// once (2000 x 1651 x 4 B each way at B = 16, 26.4 MB: 7.9 us at 3.35
// TB/s); the arithmetic, ~25 instructions a sample a pass, is small.  What
// held the one-thread-per-series kernel before it back (0.266 ms at B = 16,
// on an H100 at 700 W): a series is one dependent chain over its 1651
// samples, and 2000 threads filled 32 blocks of 2 warps on 132 SMs; at B = 1
// two blocks ran the same chain.  What this design does:
//   - The cascade is one linear time-invariant system with N = 2 n_sections
//     states, s_{t+1} = A s_t + b x_t, y_t = c s_t + d x_t.  A series is cut
//     into C <= 32 chunks of L samples (L odd, from the wrapper; the last
//     chunk shorter), one lane each:
//     1. every chunk but the last runs from a zero state and keeps its final
//        state z_c;
//     2. the entry states follow from s_0 = 0, s_{c+1} = A^L s_c + z_c, one
//        N x N product a chunk, by the series' warp: lane r < N computes
//        state r, reading s_c from the other lanes by shuffles; s_{c+1}
//        takes z_c's place in shared memory;
//     3. every chunk runs again from its entry state and writes y.
//     The chain a lane runs is 2 L + C steps long instead of T.  A^L comes
//     from the host in float32 through the parameter space, computed in
//     float64 from the float32 coefficients the kernel runs
//     (frontend/filters.py carry_matrix); only the carry's rounding differs
//     from the sequential chain.
//   - x and y keep the (series, T) layout of the caller, so no transposed
//     copy surrounds the kernel: a block, one warp, takes one series; it
//     stages the series in shared memory with coalesced reads and writes it
//     back with coalesced writes (step 3 overwrites x with y in place, a lane
//     its own chunk).  Lane c reads sample c L + u: with L odd the 32 chunks
//     fall in 32 banks.  A series longer than shared memory holds is read and
//     written in device memory directly.  2000 blocks of one warp at B = 16,
//     125 at B = 1.  One launch a batch.
//   - Times of the alternatives, from cli/tune_split_bwd.py --program sosfilt
//     on an H100 at 700 W, before the block was fixed at one series: at
//     (2000, 1651) 0.0192 ms with 1 series a block, 0.0196 with 2 or 4,
//     0.0204 with 8; 16 chunks of 105 samples 0.0246-0.0254; at (125, 1651)
//     0.0127-0.0128 ms with 1-4 series, 0.0146 with 8, 16 chunks
//     0.0132-0.0163.  A first version, whose carry one lane ran alone (an
//     N x N product a chunk while the warp waited) and whose copies kept 4
//     loads a thread in flight, took 0.0318 ms at (2000, 1651).
//   - Coefficients and A^L arrive by value in the parameter space (constant
//     bank), divided by a0 on the host in float64 and cast to float32, as the
//     TPU wrapper does; the section count is a template parameter, so the
//     cascade indexes the coefficients by constants; a lane of the carry
//     reads its row of A^L once.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxSections = 8;
constexpr int kMaxStates = 2 * kMaxSections;
constexpr int kChunks = 32;         // chunks a series at most: its warp
constexpr int kMaxSmem = 232448;    // shared memory one block may use

struct SosParams {
  float c[kMaxSections][5];                // b0, b1, b2, a1, a2 (all divided by a0)
  float carry[kMaxStates][kMaxStates];     // A^L, row-major, over the states
};                                         // z1, z2 of section 0, then of 1, ...

// One sample through the cascade; z: the states z1, z2 of each section.
template <int NS>
__device__ __forceinline__ float cascade(float v, float (&z)[2 * NS], const SosParams& k) {
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float out = k.c[s][0] * v + z[2 * s];
    z[2 * s] = k.c[s][1] * v - k.c[s][3] * out + z[2 * s + 1];
    z[2 * s + 1] = k.c[s][2] * v - k.c[s][4] * out;
    v = out;
  }
  return v;
}

// Runs samples 0 .. n - 1 of src through the cascade from state z; with
// kWrite stores y at dst (which may be src).  Samples are loaded 8 at a
// time before the chain runs over them, so their loads are in flight
// together.
template <int NS, bool kWrite>
__device__ __forceinline__ void run_chunk(const float* src, float* dst, int n,
                                          float (&z)[2 * NS], const SosParams& k) {
  int u = 0;
  for (; u + 8 <= n; u += 8) {
    float buf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) buf[i] = src[u + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) buf[i] = cascade<NS>(buf[i], z, k);
    if constexpr (kWrite) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[u + i] = buf[i];
    }
  }
  for (; u < n; ++u) {
    const float out = cascade<NS>(src[u], z, k);
    if constexpr (kWrite) dst[u] = out;
  }
}

// dst[i] = src[i] for i < n by the warp, neighbouring lanes on neighbouring
// floats, 8 loads of a lane in flight together.
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n) {
  int i = threadIdx.x;
  for (; i + 7 * kChunks < n; i += 8 * kChunks) {
    float r[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) r[u] = src[i + u * kChunks];
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[i + u * kChunks] = r[u];
  }
  for (; i < n; i += kChunks) dst[i] = src[i];
}

// Shared memory: the chunks' states [chunk][N + 1] (an odd row stride: the
// warp's 32 rows start in 32 banks), then, staged, the series [T].
template <int NS>
size_t smem_bytes(int t_len, bool staged) {
  return sizeof(float) * (kChunks * (2 * NS + 1) + (staged ? static_cast<size_t>(t_len) : 0));
}

// One block a series, one warp: lane c runs chunk c.
template <int NS, bool kStaged>
__global__ void __launch_bounds__(kChunks)
    sosfilt_chunked_kernel(const float* __restrict__ x, float* __restrict__ y, int t_len,
                           int chunk_len, const __grid_constant__ SosParams k) {
  constexpr int N = 2 * NS;
  constexpr int ZLD = N + 1;
  extern __shared__ float smem[];
  float* states = smem;
  float* slab = smem + kChunks * ZLD;
  const int c = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * t_len;
  const int n_chunks = (t_len + chunk_len - 1) / chunk_len;

  if constexpr (kStaged) {
    copy_row(slab, x + base, t_len);
    __syncwarp();
  }
  const bool live = c < n_chunks;
  const int len = live ? min(chunk_len, t_len - c * chunk_len) : 0;
  const size_t off = static_cast<size_t>(c) * chunk_len;
  const float* src = kStaged ? slab + off : x + base + off;
  float* dst = kStaged ? slab + off : y + base + off;
  float* my_state = states + c * ZLD;
  float z[N];

  // 1. every chunk but the last from a zero state: its final state z_c
  if (live && c + 1 < n_chunks) {
#pragma unroll
    for (int r = 0; r < N; ++r) z[r] = 0.f;
    run_chunk<NS, false>(src, nullptr, len, z, k);
#pragma unroll
    for (int r = 0; r < N; ++r) my_state[r] = z[r];
  }
  __syncwarp();

  // 2. the entry states s_{c+1} = A^L s_c + z_c, in z_c's place: the warp
  // steps through the chunks, lane r < N computing state r from the lanes'
  // s_c by shuffles
  {
    const int r = c < N ? c : N - 1;
    float a_row[N];
#pragma unroll
    for (int q = 0; q < N; ++q) a_row[q] = k.carry[r][q];
    float s = 0.f;
    for (int cc = 0; cc + 1 < n_chunks; ++cc) {
      float* row = states + cc * ZLD;
      float next = row[r];
#pragma unroll
      for (int q = 0; q < N; ++q) next = fmaf(a_row[q], __shfl_sync(0xffffffffu, s, q), next);
      s = next;
      __syncwarp();
      if (c < N) row[r] = s;
    }
  }
  __syncwarp();

  // 3. every chunk from its entry state, writing y
  if (live) {
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < N; ++r) z[r] = 0.f;
    } else {
#pragma unroll
      for (int r = 0; r < N; ++r) z[r] = my_state[r - ZLD];  // s_c, in slot c - 1
    }
    run_chunk<NS, true>(src, dst, len, z, k);
  }
  if constexpr (kStaged) {
    __syncwarp();
    copy_row(y + base, slab, t_len);
  }
}

template <int NS>
int launch_ns(const float* x, float* y, int n_series, int t_len, int chunk_len,
              const SosParams& k, cudaStream_t stream) {
  const bool staged = smem_bytes<NS>(t_len, true) <= kMaxSmem;
  const size_t smem = smem_bytes<NS>(t_len, staged);
  auto kernel = staged ? sosfilt_chunked_kernel<NS, true> : sosfilt_chunked_kernel<NS, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_series, kChunks, smem, stream>>>(x, y, t_len, chunk_len, k);
  return static_cast<int>(cudaGetLastError());
}

// One launch over (n_series, t_len) in chunks of chunk_len samples.
int sosfilt_launch(const float* x, float* y, int n_series, int t_len, int n_sections,
                   int chunk_len, const SosParams& k, cudaStream_t st) {
  if (n_series < 1 || t_len < 1 || chunk_len < 1 ||
      (t_len + chunk_len - 1) / chunk_len > kChunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n_sections) {
    case 1: return launch_ns<1>(x, y, n_series, t_len, chunk_len, k, st);
    case 2: return launch_ns<2>(x, y, n_series, t_len, chunk_len, k, st);
    case 3: return launch_ns<3>(x, y, n_series, t_len, chunk_len, k, st);
    case 4: return launch_ns<4>(x, y, n_series, t_len, chunk_len, k, st);
    case 5: return launch_ns<5>(x, y, n_series, t_len, chunk_len, k, st);
    case 6: return launch_ns<6>(x, y, n_series, t_len, chunk_len, k, st);
    case 7: return launch_ns<7>(x, y, n_series, t_len, chunk_len, k, st);
    case 8: return launch_ns<8>(x, y, n_series, t_len, chunk_len, k, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

SosParams make_params(const float* coeffs, int n_sections, const float* carry) {
  SosParams k;
  std::memset(&k, 0, sizeof(k));
  std::memcpy(k.c, coeffs, sizeof(float) * 5 * n_sections);
  const int n = 2 * n_sections;
  for (int r = 0; r < n; ++r)
    for (int q = 0; q < n; ++q) k.carry[r][q] = carry[r * n + q];
  return k;
}

}  // namespace

extern "C" {

// x, y: device float32 (n_series, t_len), row-major.  coeffs: HOST float32
// (n_sections, 5) = b0, b1, b2, a1, a2; carry: HOST float32 (2 n_sections,
// 2 n_sections), the cascade's state transition over chunk_len samples
// (frontend/filters.py carry_matrix).  ceil(t_len / chunk_len) <= 32.
// Returns the cudaError_t of the launch.
int ist_sosfilt_f32(const float* x, float* y, int n_series, int t_len, const float* coeffs,
                    int n_sections, const float* carry, int chunk_len, void* stream) {
  if (n_sections < 1 || n_sections > kMaxSections || n_series < 1 || t_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SosParams k = make_params(coeffs, n_sections, carry);
  return sosfilt_launch(x, y, n_series, t_len, n_sections, chunk_len, k,
                        static_cast<cudaStream_t>(stream));
}

int ist_sosfilt_max_sections() { return kMaxSections; }

const char* ist_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
