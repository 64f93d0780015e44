// Times configurations of the float32 flash forward's 3xTF32 kernel
// (flash_fwd.cu) at the serving shapes, rate 0, and at the training shapes
// with dropout 0.1, beside the CUDA-core kernel it replaces, on one card.
// Not part of the kernel library: `python -m
// imagined_speech_translation_tpu_torch.cli.tune_split_bwd --program fwd_tf32`
// builds it as a program and runs it.
//
// Inputs are made on the card from a hash (q, k, v ~ N(0, 0.3^2), the card
// check's flat inputs).  Each configuration prints its mean time over 10
// launches after 2 and max |err| / max |ref| of out against the CUDA-core
// kernel.
#include "../flash_fwd.cu"

#include <cmath>
#include <cstdio>
#include <functional>
#include <string>
#include <utility>
#include <vector>

namespace {

__global__ void fill_normal(float* x, size_t n, uint32_t seed, float sd) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    uint32_t h = static_cast<uint32_t>(i) * 2654435761u ^ seed;
    h ^= h >> 16;
    h *= 0x85ebca6bu;
    h ^= h >> 13;
    h *= 0xc2b2ae35u;
    h ^= h >> 16;
    uint32_t h2 = h * 747796405u + 2891336453u;
    h2 ^= h2 >> 15;
    const float u1 = (h >> 8) * (1.f / 16777216.f) + 1e-7f;
    const float u2 = (h2 >> 8) * (1.f / 16777216.f);
    x[i] = sd * sqrtf(-2.f * logf(u1)) * cosf(6.2831853f * u2);
  }
}

float rel_err(const float* got, const float* want, size_t n) {
  std::vector<float> a(n), b(n);
  cudaMemcpy(a.data(), got, n * 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(b.data(), want, n * 4, cudaMemcpyDeviceToHost);
  double err = 0, top = 0;
  for (size_t i = 0; i < n; ++i) {
    err = fmax(err, fabs(a[i] - b[i]));
    top = fmax(top, fabs(b[i]));
  }
  return static_cast<float>(err / top);
}

using Launch = std::function<int(float*)>;

}  // namespace

int main() {
  struct Shape {
    int bh, s, d;
    float rate;
  };
  for (const Shape sh : {Shape{384, 1655, 128, 0.f}, Shape{192, 1655, 256, 0.f},
                         Shape{96, 1655, 128, 0.1f}, Shape{48, 1655, 256, 0.1f}}) {
    const int bh = sh.bh, S = sh.s, d = sh.d;
    const size_t n = static_cast<size_t>(bh) * S * d;
    float *q, *k, *v, *want, *o, *lse;
    for (float** p : {&q, &k, &v, &want, &o}) cudaMalloc(p, n * 4);
    cudaMalloc(&lse, static_cast<size_t>(bh) * S * 4);
    fill_normal<<<1024, 256>>>(q, n, 1, 0.3f);
    fill_normal<<<1024, 256>>>(k, n, 2, 0.3f);
    fill_normal<<<1024, 256>>>(v, n, 3, 0.3f);
    const float qscale = 1.4426950408889634f / sqrtf(static_cast<float>(d));
    // the f32 logical dropout tiles of flash_attention: 256 x 256
    const DropoutMask drop = make_dropout_mask(
        sh.rate > 0.f, 1234, static_cast<unsigned>(std::llround(sh.rate * 4294967296.0)), 256,
        256, 1.f / (1.f - sh.rate));
    const cudaStream_t st = 0;
    dispatch<float>(q, k, v, want, lse, bh, S, S, d, qscale, drop, st);
    printf("(%d, %d, %d) float32 dropout %.1f, against the CUDA-core kernel (%s):\n", bh, S, d,
           sh.rate, cudaGetErrorString(cudaDeviceSynchronize()));
    std::vector<std::pair<std::string, Launch>> runs;
#define FWD(label, ...)                                                                   \
  runs.push_back({label, [&](float* out) {                                                \
                    return __VA_ARGS__(q, k, v, out, lse, bh, S, S, d, qscale, drop, st); \
                  }})
    if (d == 128) {
      FWD("CUDA cores (the kernel replaced)", dispatch<float>);
      FWD("3xTF32 as dispatched: 16 warps, two 64-key stages", launch_tf32<128, 8, 64, 2>);
      FWD("3xTF32 16 warps, two 32-key stages", launch_tf32<128, 8, 32, 2>);
      FWD("3xTF32 16 warps, one 64-key tile", launch_tf32<128, 8, 64, 1>);
      FWD("3xTF32 16 warps, one 128-key tile", launch_tf32<128, 8, 128, 1>);
      FWD("3xTF32 8 warps (64 queries a block), two 64-key stages",
          launch_tf32<128, 4, 64, 2>);
    } else {
      FWD("CUDA cores (the kernel replaced)", dispatch<float>);
      FWD("3xTF32 as dispatched: 8 warps, one 64-key tile", launch_tf32<256, 4, 64, 1>);
      FWD("3xTF32 8 warps, two 32-key stages", launch_tf32<256, 4, 32, 2>);
      FWD("3xTF32 8 warps, one 32-key tile", launch_tf32<256, 4, 32, 1>);
      FWD("3xTF32 10 warps (80 queries a block), two 32-key stages", launch_tf32<256, 5, 32, 2>);
      FWD("3xTF32 12 warps (96 queries a block), one 32-key tile", launch_tf32<256, 6, 32, 1>);
    }
#undef FWD
    for (auto& run : runs) {
      const int rc = run.second(o);
      const cudaError_t err = cudaDeviceSynchronize();
      if (rc || err) {
        printf("  %-58s launch failed: %d %s\n", run.first.c_str(), rc, cudaGetErrorString(err));
        return 1;
      }
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      for (int i = 0; i < 2; ++i) run.second(o);
      cudaEventRecord(a);
      for (int i = 0; i < 10; ++i) run.second(o);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("  %-58s %8.3f ms  out %.2e\n", run.first.c_str(), ms / 10, rel_err(o, want, n));
    }
    for (float* p : {q, k, v, want, o, lse}) cudaFree(p);
  }
  return 0;
}
