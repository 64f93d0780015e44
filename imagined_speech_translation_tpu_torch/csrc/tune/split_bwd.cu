// Times configurations of the float32 split backward's 3xTF32 kernels
// (flash_bwd_split.cu) at the eval-mode gradient's shapes, and the bare rate
// of mma.sync m16n8k8 in TF32, on one card.  Not part of the kernel library:
// `python -m imagined_speech_translation_tpu_torch.cli.tune_split_bwd`
// builds it as a program and runs it.
//
// Inputs are made on the card from a hash (q, k ~ N(0, 0.3^2), v ~ N(0.5,
// 0.3^2), dO ~ N(0, 1), the card check's distributions); lse and delta come
// from a plain forward pass.  Each configuration prints its mean time over 10
// launches after 2 and max |err| / max |ref| against the CUDA-core kernels.
#include "../flash_bwd_split.cu"

#include <cmath>
#include <cstdio>
#include <functional>
#include <string>
#include <utility>
#include <vector>

namespace {

__global__ void fill_normal(float* x, size_t n, uint32_t seed, float sd, float mean) {
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
    x[i] = mean + sd * sqrtf(-2.f * logf(u1)) * cosf(6.2831853f * u2);
  }
}

// lse (base 2) and delta = rowsum(dO * O) by an online softmax, one warp a row
__global__ void plain_forward(const float* q, const float* k, const float* v, const float* dout,
                              float* lse, float* delta, int rows, int s, int d, float qscale) {
  __shared__ float o_all[4][256];
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float* o = o_all[threadIdx.x / 32];
  const float* qr = q + static_cast<size_t>(row) * d;
  const size_t head = static_cast<size_t>(row / s) * s;
  for (int c = lane; c < d; c += 32) o[c] = 0.f;
  float m = -1e30f, l = 0.f;
  for (int j = 0; j < s; ++j) {
    const float* kr = k + (head + j) * d;
    const float* vr = v + (head + j) * d;
    float dot = 0.f;
    for (int c = lane; c < d; c += 32) dot += qr[c] * kr[c];
    for (int off = 16; off; off /= 2) dot += __shfl_xor_sync(~0u, dot, off);
    const float x = dot * qscale, mn = fmaxf(m, x), a = exp2f(m - mn), p = exp2f(x - mn);
    l = l * a + p;
    for (int c = lane; c < d; c += 32) o[c] = o[c] * a + p * vr[c];
    m = mn;
  }
  float dl = 0.f;
  for (int c = lane; c < d; c += 32) dl += dout[static_cast<size_t>(row) * d + c] * o[c] / l;
  for (int off = 16; off; off /= 2) dl += __shfl_xor_sync(~0u, dl, off);
  if (lane == 0) {
    lse[row] = m + log2f(l);
    delta[row] = dl;
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

// CH independent accumulators a warp, no loads: the instruction's own rate
template <int CH>
__global__ void __launch_bounds__(256) mma_rate(float* out, int iters) {
  float acc[CH][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x * 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CH; ++c) mma_tf32(acc[c], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH>
void time_mma(int sms, int blocks_per_sm) {
  float* out;
  cudaMalloc(&out, static_cast<size_t>(sms) * blocks_per_sm * 256 * 4);
  const int iters = 4096;
  mma_rate<CH><<<sms * blocks_per_sm, 256>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  mma_rate<CH><<<sms * blocks_per_sm, 256>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double flops = 2.0 * 16 * 8 * 8 * CH * iters * 8.0 * sms * blocks_per_sm;
  printf("mma.sync m16n8k8 tf32, %2d accumulators a warp, %2d warps an SM: %6.1f TFLOP/s %s\n",
         CH, 8 * blocks_per_sm, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

using Launch = std::function<int(const float*, const float*, const float*, const float*,
                                 const float*, const float*, float*, float*, float*)>;

}  // namespace

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  time_mma<4>(sms, 1);
  time_mma<8>(sms, 1);
  time_mma<8>(sms, 2);
  time_mma<16>(sms, 2);
  struct Shape {
    int bh, s, d;
  };
  for (const Shape sh : {Shape{192, 1655, 128}, Shape{96, 1655, 256}}) {
    const int bh = sh.bh, S = sh.s, d = sh.d;
    const size_t n = static_cast<size_t>(bh) * S * d;
    float *q, *k, *v, *dout, *lse, *delta, *want_dq, *want_dk, *want_dv, *dq, *dk, *dv;
    for (float** p : {&q, &k, &v, &dout, &want_dq, &want_dk, &want_dv, &dq, &dk, &dv})
      cudaMalloc(p, n * 4);
    cudaMalloc(&lse, static_cast<size_t>(bh) * S * 4);
    cudaMalloc(&delta, static_cast<size_t>(bh) * S * 4);
    fill_normal<<<1024, 256>>>(q, n, 1, 0.3f, 0.f);
    fill_normal<<<1024, 256>>>(k, n, 2, 0.3f, 0.f);
    fill_normal<<<1024, 256>>>(v, n, 3, 0.3f, 0.5f);
    fill_normal<<<1024, 256>>>(dout, n, 4, 1.f, 0.f);
    const float scale = 1.f / sqrtf(static_cast<float>(d)), qscale = scale * 1.4426950408889634f;
    plain_forward<<<(bh * S + 3) / 4, 128>>>(q, k, v, dout, lse, delta, bh * S, S, d, qscale);
    const cudaStream_t st = 0;
    dispatch_dq<float>(q, k, v, dout, lse, delta, want_dq, bh, S, S, d, qscale, scale, st);
    const DropoutMask none = make_dropout_mask(0, 0, 0, 0, 0, 1.f);
    key_tile_backward<false>(q, k, v, dout, lse, delta, nullptr, want_dk, want_dv, bh, S, S, d,
                             qscale, scale, 0, none, st);
    printf("(%d, %d, %d) float32, against the CUDA-core kernels (%s):\n", bh, S, d,
           cudaGetErrorString(cudaDeviceSynchronize()));
    std::vector<std::pair<std::string, Launch>> runs;
#define DQ(label, ...)                                                                   \
  runs.push_back({label, [&](const float* a, const float* b, const float* c, const float* e, \
                             const float* l, const float* de, float* x, float*, float*) {  \
                    return __VA_ARGS__(a, b, c, e, l, de, x, bh, S, S, d, qscale, scale, st); \
                  }})
#define DKV(label, ...)                                                                  \
  runs.push_back({label, [&](const float* a, const float* b, const float* c, const float* e, \
                             const float* l, const float* de, float*, float* y, float* z) {  \
                    return __VA_ARGS__(a, b, c, e, l, de, y, z, bh, S, S, d, qscale, scale,   \
                                       st);                                                  \
                  }})
    if (d == 128) {
      DQ("dQ  as dispatched: 16 warps, two 32-key stages", launch_dq_tf32<128, 8, 32, 2>);
      DQ("dQ  16 warps, one 32-key tile", launch_dq_tf32<128, 8, 32, 1>);
      DQ("dQ  8 warps (64 queries a block), two 32-key stages",
         launch_dq_tf32<128, 4, 32, 2>);
      DKV("dKV as dispatched: 2 blocks of 8 warps, 32-query tiles", launch_dkv_tf32<128, 32, 2>);
      DKV("dKV 2 blocks of 8 warps, 16-query tiles", launch_dkv_tf32<128, 16, 2>);
      DKV("dKV registers unbounded (1 block of 8 warps), 32-query tiles",
          launch_dkv_tf32<128, 32, 1>);
    } else {
      DQ("dQ  as dispatched: 8 warps, one 32-key tile", launch_dq_tf32<256, 4, 32, 1>);
      DKV("dKV as dispatched: 8 warps, 32-query tiles", launch_dkv_tf32<256, 32, 1>);
      DKV("dKV 8 warps, 16-query tiles", launch_dkv_tf32<256, 16, 1>);
    }
#undef DQ
#undef DKV
    for (auto& run : runs) {
      const int rc = run.second(q, k, v, dout, lse, delta, dq, dk, dv);
      const cudaError_t err = cudaDeviceSynchronize();
      if (rc || err) {
        printf("  %-62s launch failed: %d %s\n", run.first.c_str(), rc, cudaGetErrorString(err));
        return 1;
      }
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      for (int i = 0; i < 2; ++i) run.second(q, k, v, dout, lse, delta, dq, dk, dv);
      cudaEventRecord(a);
      for (int i = 0; i < 10; ++i) run.second(q, k, v, dout, lse, delta, dq, dk, dv);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      if (run.first.rfind("dQ", 0) == 0)
        printf("  %-62s %8.3f ms  dq %.2e\n", run.first.c_str(), ms / 10,
               rel_err(dq, want_dq, n));
      else
        printf("  %-62s %8.3f ms  dk %.2e dv %.2e\n", run.first.c_str(), ms / 10,
               rel_err(dk, want_dk, n), rel_err(dv, want_dv, n));
    }
    for (float* p : {q, k, v, dout, lse, delta, want_dq, want_dk, want_dv, dq, dk, dv}) cudaFree(p);
  }
  return 0;
}
