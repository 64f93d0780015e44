// Times configurations of the float32 fused backward's 3xTF32 kernel
// (flash_bwd_tf32_kernel of flash_bwd_tf32.cuh, as flash_bwd.cu dispatches
// it) at the f32 training shapes with dropout 0.1 on the f32 logical tiles
// (256 x 256), beside the CUDA-core kernel it replaces and the split dK/dV
// kernel that shares its template, on one card.  Not part of the kernel
// library: `python -m imagined_speech_translation_tpu_torch.cli.tune_split_bwd
// --program bwd_tf32` builds it as a program and runs it.
//
// Inputs are made on the card from a hash (q, k, v ~ N(0, 0.3^2), dO ~ N(0,
// 1), the card check's training inputs); lse and delta come from a plain
// forward pass.  Each configuration prints its mean time over 10 launches
// after 2, each launch with the memset that zeroes dQ before it, and max |err|
// / max |ref| of dQ, dK and dV against the CUDA-core kernel at the same rate.
#include "../flash_bwd.cu"

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

struct Run {
  std::string label;
  bool dropout;  // else rate 0
  bool dq;       // else dK/dV alone (the split kernel)
  std::function<int(float*, float*, float*)> launch;
};

}  // namespace

int main() {
  struct Shape {
    int bh, s, d;
  };
  for (const Shape sh : {Shape{96, 1655, 128}, Shape{48, 1655, 256}}) {
    const int bh = sh.bh, S = sh.s, d = sh.d;
    const size_t n = static_cast<size_t>(bh) * S * d;
    float *q, *k, *v, *dout, *lse, *delta, *dq, *dk, *dv;
    float* want[2][3];  // [rate 0, 0.1][dq, dk, dv] from the CUDA-core kernel
    for (float** p : {&q, &k, &v, &dout, &dq, &dk, &dv}) cudaMalloc(p, n * 4);
    for (auto& w : want)
      for (float*& p : w) cudaMalloc(&p, n * 4);
    cudaMalloc(&lse, static_cast<size_t>(bh) * S * 4);
    cudaMalloc(&delta, static_cast<size_t>(bh) * S * 4);
    fill_normal<<<1024, 256>>>(q, n, 1, 0.3f);
    fill_normal<<<1024, 256>>>(k, n, 2, 0.3f);
    fill_normal<<<1024, 256>>>(v, n, 3, 0.3f);
    fill_normal<<<1024, 256>>>(dout, n, 4, 1.f);
    const float scale = 1.f / sqrtf(static_cast<float>(d)), qscale = scale * 1.4426950408889634f;
    plain_forward<<<(bh * S + 3) / 4, 128>>>(q, k, v, dout, lse, delta, bh * S, S, d, qscale);
    // the f32 logical dropout tiles of flash_attention at S = 1655: 256 x 256
    const DropoutMask drops[2] = {
        make_dropout_mask(0, 0, 0, 0, 0, 1.f),
        make_dropout_mask(1, 1234, static_cast<unsigned>(std::llround(0.1 * 4294967296.0)), 256,
                          256, 1.f / 0.9f)};
    const cudaStream_t st = 0;
    for (int r = 0; r < 2; ++r) {
      cudaMemset(want[r][0], 0, n * 4);
      key_tile_backward<true>(q, k, v, dout, lse, delta, want[r][0], want[r][1], want[r][2], bh,
                              S, S, d, qscale, scale, 0, drops[r], st);
    }
    printf("(%d, %d, %d) float32, dropout 0.1 unless marked, against the CUDA-core kernel "
           "(%s):\n", bh, S, d, cudaGetErrorString(cudaDeviceSynchronize()));
    std::vector<Run> runs;
#define RUN(label, drop_on, with_dq, ...)                                                     \
  runs.push_back({label, drop_on, with_dq, [&](float* x, float* y, float* z) {               \
                    return __VA_ARGS__(q, k, v, dout, lse, delta, x, y, z, bh, S, S, d,      \
                                       qscale, scale, drops[drop_on], st);                   \
                  }})
    auto core = [&](const void* a, const void* b, const void* c, const void* e, const float* l,
                    const float* de, float* x, void* y, void* z, int bh_, int s_q, int s_kv,
                    int d_, float qs, float sc, const DropoutMask& m, cudaStream_t s_) {
      return key_tile_backward<true>(a, b, c, e, l, de, x, y, z, bh_, s_q, s_kv, d_, qs, sc, 0, m,
                                     s_);
    };
    auto dkv = [&](const void* a, const void* b, const void* c, const void* e, const float* l,
                   const float* de, float*, void* y, void* z, int bh_, int s_q, int s_kv, int d_,
                   float qs, float sc, const DropoutMask&, cudaStream_t s_) {
      return d_ <= 128
                 ? launch_dkv_tf32<128, 32, 2>(a, b, c, e, l, de, y, z, bh_, s_q, s_kv, d_, qs, sc,
                                               s_)
                 : launch_dkv_tf32<256, 32, 1>(a, b, c, e, l, de, y, z, bh_, s_q, s_kv, d_, qs, sc,
                                               s_);
    };
    RUN("CUDA cores (the kernel replaced)", 1, true, core);
    RUN("CUDA cores, rate 0", 0, true, core);
    RUN("as dispatched", 1, true, dispatch_bwd_tf32);
    RUN("as dispatched, rate 0 (no mask)", 0, true, dispatch_bwd_tf32);
    RUN("split dK/dV kernel (rate 0, no dQ)", 0, false, dkv);
    if (d == 128) {
      RUN("dQ 2 n-tiles x 2 m-tiles at once, 8-key slices unrolled 2", 1, true,
          launch_bwd_tf32<128, 32, 4, 2, 2, 2, 2, true>);
      RUN("dQ 2 x 2 at once, not unrolled", 1, true,
          launch_bwd_tf32<128, 32, 4, 2, 2, 2, 1, true>);
      RUN("dQ 1 x 2 at once, not unrolled", 1, true,
          launch_bwd_tf32<128, 32, 4, 2, 1, 2, 1, true>);
      RUN("dQ 1 x 1 at once, unrolled 2", 1, true, launch_bwd_tf32<128, 32, 4, 2, 1, 1, 2, true>);
      RUN("16-query tiles, dQ 2 x 1 at once", 1, true,
          launch_bwd_tf32<128, 16, 4, 2, 2, 1, 2, true>);
      RUN("registers unbounded (1 block an SM), dQ 2 x 2", 1, true,
          launch_bwd_tf32<128, 32, 4, 1, 2, 2, 2, true>);
      RUN("8 pairs (128 keys), 1 block of 16 warps, dQ 1 x 2", 1, true,
          launch_bwd_tf32<128, 32, 8, 1, 1, 2, 1, true>);
    } else {
      RUN("dQ 2 n-tiles a pass", 1, true, launch_bwd_tf32<256, 32, 4, 1, 2, 2, 2, true>);
      RUN("dQ 4 n-tiles, not unrolled", 1, true, launch_bwd_tf32<256, 32, 4, 1, 4, 2, 1, true>);
      RUN("16-query tiles", 1, true, launch_bwd_tf32<256, 16, 4, 1, 4, 1, 2, true>);
    }
#undef RUN
    for (auto& run : runs) {
      auto once = [&] {
        cudaMemsetAsync(dq, 0, n * 4, st);
        return run.launch(dq, dk, dv);
      };
      const int rc = once();
      const cudaError_t err = cudaDeviceSynchronize();
      if (rc || err) {
        printf("  %-62s launch failed: %d %s\n", run.label.c_str(), rc, cudaGetErrorString(err));
        return 1;
      }
      const int r = run.dropout ? 1 : 0;
      const float e_dq = run.dq ? rel_err(dq, want[r][0], n) : -1.f;
      const float e_dk = rel_err(dk, want[r][1], n), e_dv = rel_err(dv, want[r][2], n);
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      for (int i = 0; i < 2; ++i) once();
      cudaEventRecord(a);
      for (int i = 0; i < 10; ++i) once();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("  %-62s %8.3f ms  dq %.2e dk %.2e dv %.2e\n", run.label.c_str(), ms / 10, e_dq,
             e_dk, e_dv);
    }
    for (float* p : {q, k, v, dout, lse, delta, dq, dk, dv}) cudaFree(p);
    for (auto& w : want)
      for (float* p : w) cudaFree(p);
  }
  return 0;
}
