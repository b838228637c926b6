// K-FIR: direct causal real FIR, y[t] = sum_k taps[k] * x[t - k], with the
// T-1 samples before each row taken from `hist` (zeros when null).
//
// Replaces radiocore_tpu/kernels/fir_pallas.py `_fir_blocks` (body
// `_fir_kernel`, vmap wrapper `_batched_call`, entry `fir_causal_pallas`),
// which ran the FIR as banded-Toeplitz matmuls on the TPU's MXU.
//
// What bounds it on an H100: one read of x and one write of y (8 bytes per
// sample); the halo re-read adds (T-1)/kTile. At the de-emphasis size
// (51 taps) the 2*T flops per sample stay under the float32 FMA rate.
//
// What the design does about it: each block stages one tile of its row
// plus the T-1 sample halo in shared memory, taps beside it, and every
// output is an in-order float32 FMA sum: no TF32, no tensor cores, no
// matrix padding. Rows and tiles are one flat grid, so any batch works.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 4096;

__global__ void __launch_bounds__(kThreads)
    fir_kernel(const float* __restrict__ x, long long x_stride,
               const float* __restrict__ hist, long long hist_stride,
               const float* __restrict__ taps, float* __restrict__ y,
               long long n, int T, long long ntiles) {
  extern __shared__ float sh[];
  float* tp = sh;
  float* xs = sh + T;
  const int H = T - 1;
  const long long row = blockIdx.x / ntiles;
  const long long tile0 = (blockIdx.x % ntiles) * kTile;
  const float* xr = x + row * x_stride;

  for (int i = threadIdx.x; i < T; i += blockDim.x) tp[i] = taps[i];
  for (int i = threadIdx.x; i < kTile + H; i += blockDim.x) {
    const long long p = tile0 - H + i;
    float v = 0.f;
    if (p >= 0) {
      if (p < n) v = xr[p];
    } else if (hist != nullptr) {
      v = hist[row * hist_stride + H + p];
    }
    xs[i] = v;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < kTile; o += blockDim.x) {
    const long long t = tile0 + o;
    if (t >= n) break;
    const float* xo = xs + o + H;
    float acc = 0.f;
    for (int k = 0; k < T; ++k) acc = fmaf(tp[k], xo[-k], acc);
    y[row * n + t] = acc;
  }
}

}  // namespace

extern "C" int rc_fir(const void* x, long long x_stride, const void* hist,
                      long long hist_stride, const void* taps, void* y,
                      long long rows, long long n, int T, void* stream) {
  if (rows < 1 || n < 1 || T < 1 || T > kMaxTaps) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long blocks = rows * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * ((size_t)T + kTile + T - 1);
  fir_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, x_stride, (const float*)hist, hist_stride,
      (const float*)taps, (float*)y, n, T, ntiles);
  return (int)cudaGetLastError();
}
