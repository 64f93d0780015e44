// Times configurations of the chunked IIR (sosfilt_chunked_kernel of
// sosfilt.cu) at the serving shapes, (2000, 1651) at B = 16 and (125, 1651)
// at B = 1, on one card: 32 chunks a series, as the wrapper cuts them, and
// 16.  Not part of the kernel library: `python -m
// imagined_speech_translation_tpu_torch.cli.tune_split_bwd --program sosfilt`
// builds it as a program and runs it with the serving filters' sections
// (b0 b1 b2 a1 a2 of each, divided by a0) as arguments.
//
// Inputs are made on the card from a hash (x ~ N(0, 4^2)).  Each
// configuration prints its mean time over 50 launches after 5 and max |err|
// / max |x| against a sequential float32 twin, one thread a series.
#include "../sosfilt.cu"

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
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

// the sequential recurrence, one thread a series of the (series, T) layout
template <int NS>
__global__ void sequential(const float* x, float* y, int n_series, int t_len, SosParams k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_series) return;
  float z[2 * NS] = {};
  for (int t = 0; t < t_len; ++t) {
    const size_t at = static_cast<size_t>(i) * t_len + t;
    y[at] = cascade<NS>(x[at], z, k);
  }
}

// A^L in float64 over the states z1, z2 of each section, row-major
std::vector<float> carry(const std::vector<double>& c, int n_sections, int chunk_len) {
  const int n = 2 * n_sections;
  std::vector<double> a(n * n), p(n * n, 0.0), tmp(n * n);
  for (int col = 0; col < n; ++col) {  // one step with zero input from unit state col
    std::vector<double> z(n, 0.0);
    z[col] = 1.0;
    double v = 0.0;
    for (int s = 0; s < n_sections; ++s) {
      const double* k = &c[5 * s];
      const double out = k[0] * v + z[2 * s];
      z[2 * s] = k[1] * v - k[3] * out + z[2 * s + 1];
      z[2 * s + 1] = k[2] * v - k[4] * out;
      v = out;
    }
    for (int r = 0; r < n; ++r) a[r * n + col] = z[r];
  }
  for (int r = 0; r < n; ++r) p[r * n + r] = 1.0;
  for (int step = 0; step < chunk_len; ++step) {
    for (int r = 0; r < n; ++r)
      for (int q = 0; q < n; ++q) {
        double s = 0.0;
        for (int m = 0; m < n; ++m) s += a[r * n + m] * p[m * n + q];
        tmp[r * n + q] = s;
      }
    p.swap(tmp);
  }
  return std::vector<float>(p.begin(), p.end());
}

int odd_chunk(int t_len, int chunks) {
  const int n = (t_len + chunks - 1) / chunks;
  return n % 2 ? n : n + 1;
}

}  // namespace

int main(int argc, char** argv) {
  const int n_sections = (argc - 1) / 5;
  if (n_sections != 5 || argc != 1 + 5 * n_sections) {
    fprintf(stderr, "usage: %s b0 b1 b2 a1 a2 (five sections)\n", argv[0]);
    return 2;
  }
  std::vector<double> c64(5 * n_sections);
  std::vector<float> c32(5 * n_sections);
  for (int i = 0; i < 5 * n_sections; ++i) {
    c32[i] = strtof(argv[1 + i], nullptr);
    c64[i] = c32[i];
  }
  for (const int n_series : {2000, 125}) {
    const int t_len = 1651;
    const size_t n = static_cast<size_t>(n_series) * t_len;
    float *x, *y, *want;
    for (float** p : {&x, &y, &want}) cudaMalloc(p, n * 4);
    fill_normal<<<1024, 256>>>(x, n, 7, 4.f);
    const SosParams seq = make_params(c32.data(), n_sections, carry(c64, n_sections, 1).data());
    sequential<5><<<(n_series + 63) / 64, 64>>>(x, want, n_series, t_len, seq);
    std::vector<float> hx(n), hw(n), hy(n);
    cudaMemcpy(hx.data(), x, n * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(hw.data(), want, n * 4, cudaMemcpyDeviceToHost);
    double top = 0;
    for (float v : hx) top = fmax(top, fabs(v));
    printf("(%d, %d) float32, against the sequential twin (%s):\n", n_series, t_len,
           cudaGetErrorString(cudaDeviceSynchronize()));
    for (size_t ci = 0; ci < 2; ++ci) {
      const int chunks = ci == 0 ? 32 : 16;
      const int chunk_len = odd_chunk(t_len, chunks);
      const SosParams k =
          make_params(c32.data(), n_sections, carry(c64, n_sections, chunk_len).data());
      auto run = [&] {
        return sosfilt_launch(x, y, n_series, t_len, n_sections, chunk_len, k, 0);
      };
      const int rc = run();
      const cudaError_t err = cudaDeviceSynchronize();
      if (rc || err) {
        printf("  %d chunks: launch failed: %d %s\n", chunks, rc, cudaGetErrorString(err));
        return 1;
      }
      cudaMemcpy(hy.data(), y, n * 4, cudaMemcpyDeviceToHost);
      double e = 0;
      for (size_t i = 0; i < n; ++i) e = fmax(e, fabs(hy[i] - hw[i]));
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      for (int i = 0; i < 5; ++i) run();
      cudaEventRecord(a);
      for (int i = 0; i < 50; ++i) run();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("  %s%2d chunks of %3d: %8.4f ms  err %.2e of max|x|\n",
             ci == 0 ? "as dispatched: " : "               ", chunks, chunk_len, ms / 50,
             e / top);
    }
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    for (int i = 0; i < 5; ++i)
      sequential<5><<<(n_series + 63) / 64, 64>>>(x, want, n_series, t_len, seq);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    printf("  the sequential twin, one thread a series:    %8.4f ms\n", ms / 5);
    for (float* p : {x, y, want}) cudaFree(p);
  }
  return 0;
}
