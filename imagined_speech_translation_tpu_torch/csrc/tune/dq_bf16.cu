// Times configurations of the bf16 split dQ kernel (flash_bwd_dq_wgmma_kernel
// of flash_bwd_split.cu) at the eval-mode gradient's shapes in bf16, (192,
// 1655, 128) and (96, 1655, 256), and at head dim 192 (the reference heads
// (8,4,4)), on one card: the depth of the K and V rings,
// queries a block (two consumer warpgroups or one), and whether S and dP of
// one key tile run beside the dQ product of the one before.  Not part of the
// kernel library: `python -m imagined_speech_translation_tpu_torch.cli.tune_split_bwd
// --program dq_bf16` builds it as a program and runs it.
//
// Inputs are made on the card from a hash (q, k ~ N(0, 0.3^2), v ~ N(0.5,
// 0.3^2), dO ~ N(0, 1), the card check's distributions) and rounded to bf16;
// lse and delta come from a plain float32 forward pass on the rounded values.
// Each configuration prints its mean time over 10 launches after 2, its rate
// (6 bh s^2 d FLOPs) and max |err| / max |ref| against the CUDA-core kernel
// in bf16.
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

// x rounded to bf16 into b, and x replaced by the rounded value
__global__ void round_bf16(float* x, __nv_bfloat16* b, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    b[i] = __float2bfloat16(x[i]);
    x[i] = __bfloat162float(b[i]);
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

float rel_err(const __nv_bfloat16* got, const __nv_bfloat16* want, size_t n) {
  std::vector<__nv_bfloat16> a(n), b(n);
  cudaMemcpy(a.data(), got, n * 2, cudaMemcpyDeviceToHost);
  cudaMemcpy(b.data(), want, n * 2, cudaMemcpyDeviceToHost);
  double err = 0, top = 0;
  for (size_t i = 0; i < n; ++i) {
    const double x = __bfloat162float(a[i]), y = __bfloat162float(b[i]);
    err = fmax(err, fabs(x - y));
    top = fmax(top, fabs(y));
  }
  return static_cast<float>(err / top);
}

using Launch = std::function<int(const void*, const void*, const void*, const void*,
                                 const float*, const float*, void*)>;

}  // namespace

int main() {
  struct Shape {
    int bh, s, d;
  };
  for (const Shape sh : {Shape{192, 1655, 128}, Shape{96, 1655, 256}, Shape{96, 1655, 192}}) {
    const int bh = sh.bh, S = sh.s, d = sh.d;
    const size_t n = static_cast<size_t>(bh) * S * d;
    float *qf, *kf, *vf, *df, *lse, *delta;
    __nv_bfloat16 *q, *k, *v, *dout, *want, *dq;
    for (float** p : {&qf, &kf, &vf, &df}) cudaMalloc(p, n * 4);
    for (__nv_bfloat16** p : {&q, &k, &v, &dout, &want, &dq}) cudaMalloc(p, n * 2);
    cudaMalloc(&lse, static_cast<size_t>(bh) * S * 4);
    cudaMalloc(&delta, static_cast<size_t>(bh) * S * 4);
    fill_normal<<<1024, 256>>>(qf, n, 1, 0.3f, 0.f);
    fill_normal<<<1024, 256>>>(kf, n, 2, 0.3f, 0.f);
    fill_normal<<<1024, 256>>>(vf, n, 3, 0.3f, 0.5f);
    fill_normal<<<1024, 256>>>(df, n, 4, 1.f, 0.f);
    round_bf16<<<1024, 256>>>(qf, q, n);
    round_bf16<<<1024, 256>>>(kf, k, n);
    round_bf16<<<1024, 256>>>(vf, v, n);
    round_bf16<<<1024, 256>>>(df, dout, n);
    const float scale = 1.f / sqrtf(static_cast<float>(d)), qscale = scale * 1.4426950408889634f;
    plain_forward<<<(bh * S + 3) / 4, 128>>>(qf, kf, vf, df, lse, delta, bh * S, S, d, qscale);
    const cudaStream_t st = 0;
    dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, want, bh, S, S, d, qscale, scale, st);
    printf("(%d, %d, %d) bfloat16, against the CUDA-core kernel (%s):\n", bh, S, d,
           cudaGetErrorString(cudaDeviceSynchronize()));
    std::vector<std::pair<std::string, Launch>> runs;
#define DQ(label, ...)                                                                     \
  runs.push_back({label, [&](const void* a, const void* b, const void* c, const void* e,     \
                             const float* l, const float* de, void* x) {                    \
                    return __VA_ARGS__(a, b, c, e, l, de, x, bh, S, S, d, qscale, scale, st); \
                  }})
    if (d == 128) {
      DQ("as dispatched: 128 queries, K/V rings 3/3, overlapped",
         launch_dq_wgmma<2, 2, 3, 3, true>);
      DQ("128 queries, K/V rings 2/2, overlapped", launch_dq_wgmma<2, 2, 2, 2, true>);
      DQ("128 queries, K/V rings 4/4, overlapped", launch_dq_wgmma<2, 2, 4, 4, true>);
      DQ("128 queries, K/V rings 4/2, overlapped", launch_dq_wgmma<2, 2, 4, 2, true>);
      DQ("128 queries, K/V rings 3/3, in turn", launch_dq_wgmma<2, 2, 3, 3, false>);
      DQ("64 queries, K/V rings 3/3, overlapped", launch_dq_wgmma<2, 1, 3, 3, true>);
    } else if (d == 192) {
      DQ("as dispatched: 128 queries, K/V rings 3/2, overlapped",
         launch_dq_wgmma<3, 2, 3, 2, true>);
      DQ("128 queries, K/V rings 3/2, in turn", launch_dq_wgmma<3, 2, 3, 2, false>);
      DQ("128 queries, K/V rings 2/2, overlapped", launch_dq_wgmma<3, 2, 2, 2, true>);
    } else {
      DQ("as dispatched: 128 queries, K/V rings 2/1, in turn",
         launch_dq_wgmma<4, 2, 2, 1, false>);
      DQ("128 queries, K/V rings 2/1, overlapped (spills)", launch_dq_wgmma<4, 2, 2, 1, true>);
      DQ("128 queries, K/V rings 1/1, in turn", launch_dq_wgmma<4, 2, 1, 1, false>);
      DQ("64 queries, K/V rings 2/2, overlapped", launch_dq_wgmma<4, 1, 2, 2, true>);
      DQ("64 queries, K/V rings 3/2, overlapped", launch_dq_wgmma<4, 1, 3, 2, true>);
      DQ("64 queries, K/V rings 2/2, in turn", launch_dq_wgmma<4, 1, 2, 2, false>);
    }
#undef DQ
    const double flops = 6.0 * bh * static_cast<double>(S) * S * d;
    for (auto& run : runs) {
      const int rc = run.second(q, k, v, dout, lse, delta, dq);
      const cudaError_t err = cudaDeviceSynchronize();
      if (rc || err) {
        printf("  %-58s launch failed: %d %s\n", run.first.c_str(), rc, cudaGetErrorString(err));
        if (err) return 1;  // a fault leaves the context unusable
        continue;
      }
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      for (int i = 0; i < 2; ++i) run.second(q, k, v, dout, lse, delta, dq);
      cudaEventRecord(a);
      for (int i = 0; i < 10; ++i) run.second(q, k, v, dout, lse, delta, dq);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("  %-58s %8.3f ms %6.1f TFLOP/s  dq %.2e\n", run.first.c_str(), ms / 10,
             flops / (ms / 10) / 1e9, rel_err(dq, want, n));
    }
    for (float* p : {qf, kf, vf, df, lse, delta}) cudaFree(p);
    for (__nv_bfloat16* p : {q, k, v, dout, want, dq}) cudaFree(p);
  }
  return 0;
}
