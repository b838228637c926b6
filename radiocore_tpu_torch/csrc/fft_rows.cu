// K-FFT: batched unnormalized power-of-two complex FFT of rows, and the
// rfft untangle and irfft tangle around it.
//
// Replaces radiocore_tpu/kernels/fft_pallas.py `_fft_call` (body
// `_fft_kernel` / `_dft_row_2d`) and, above one row, the XLA-level
// four-step of `fft_large_pow2_pallas` / `_four_step_pallas`; the
// untangle and tangle are the elementwise halves of `rfft_pow2_pallas`
// and `irfft_pow2_pallas`.
//
// What bounds it on an H100: device-memory traffic. Each pass reads and
// writes the whole array once (16 bytes per complex64 point), so a
// transform costs 16 B x points x passes: two passes for the 64 x 2^18
// station rows and for the 2^24 band (4096 x 4096), 268 MB per pass at
// the band size. The arithmetic (5 N log2 N flops) is far below the
// card's float32 rate. Of each transform's four sides (load and store of
// two passes) three are strided: they move runs of P points, and what
// they cost is the rest of the gap to a plain copy.
//
// What the design does about it: the TPU kernel held a whole 2 MB row in
// VMEM; a block here has at most 227 KB of shared memory, so a row is cut
// into sub-FFTs of at most 4096 points (fft_common.cuh: 16 points per
// thread, Stockham radix-16/8/4 stages, two blocks per SM below L = 4096)
// and the host plan chains the fewest passes that cover it. The four-step
// twiddle is fused into the first pass's store and the last pass stores
// straight to natural order, so no transpose pass or twiddle pass exists.
// A block works on P >= 4 neighbouring sub-FFTs so that strided loads and
// stores move whole 32-byte sectors (128 bytes at L = 512), two sub-FFTs
// per 16-byte access. The untangle and tangle are one kernel each, one
// read and one write, with the 1/h of irfft folded into the tangle.
#include "fft_common.cuh"

extern "C" int rc_fft_pass(const void* in, void* out, int L, int P,
                           long long S, long long B0, long long B1,
                           long long ib0, long long ib1, long long is,
                           long long ij, long long ob0, long long ob1,
                           long long os, long long ok, long long tw_n,
                           int sign, void* stream) {
  const rc::Extract none = {1, 2, 0, 0.f};
  rc::Pass d;
  int err = rc::make_pass(&d, L, P, S, B0, B1, ib0, ib1, is, ij, ob0, ob1, os,
                          ok, tw_n, sign, rc::kStoreStrided, 0);
  if (err) return err;
  err = rc::prepare_pass<rc::kLoadStrided, rc::kStoreStrided>(d);
  if (err) return err;
  return rc::enqueue_pass<rc::kLoadStrided, rc::kStoreStrided>(
      (const float2*)in, (float2*)out, d, none, (cudaStream_t)stream);
}

namespace rc {

// rfft's untangle: X[k] = A[k]*Z[k] + B[k]*conj(Z[h-k]) for k = 0..h, with
// Z[h] = Z[0], A = (1 - i*w)/2, B = (1 + i*w)/2, w = exp(-2*pi*i*k/n),
// n = 2h. Thread (row, k), k <= h/2, writes X[k] and X[h-k] from the same
// two loads; w[h-k] = -conj(w[k]), and 2k/n is exact in float32.
__global__ void rfft_untangle_kernel(const float2* __restrict__ z,
                                     float2* __restrict__ x, long long rows,
                                     int h) {
  const long long half = h / 2 + 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  const long long row = idx / half;
  const int k = (int)(idx - row * half);
  const float2* zr = z + row * h;
  float2* xr = x + row * (h + 1);
  const float2 zk = zr[k], zm = zr[k == 0 ? 0 : h - k];
  float sn, cs;
  sincospif((float)k / (float)h, &sn, &cs);
  // w = (cs, -sn); A = ((1 + w.y)/2, -w.x/2), B = ((1 - w.y)/2, w.x/2).
  float2 a = make_float2(0.5f * (1.0f - sn), -0.5f * cs);
  float2 b = make_float2(0.5f * (1.0f + sn), 0.5f * cs);
  xr[k] = cadd(cmul(a, zk), cmul(b, make_float2(zm.x, -zm.y)));
  // At h - k: w = (-cs, -sn).
  a = make_float2(0.5f * (1.0f - sn), 0.5f * cs);
  b = make_float2(0.5f * (1.0f + sn), -0.5f * cs);
  xr[h - k] = cadd(cmul(a, zm), cmul(b, make_float2(zk.x, -zk.y)));
}

// irfft's tangle, the inverse of the above, times 1/h: with X's DC and
// Nyquist imaginary parts dropped and W = exp(+2*pi*i*k/n),
//     Z[k] = (ze + i*zo)/h, ze = (X[k] + conj(X[h-k]))/2,
//     zo = (X[k] - conj(X[h-k]))/2 * W[k],  k < h,
// whose unnormalized backward h-point FFT holds irfft(X, n) as (even, odd)
// sample pairs. Thread (row, k), k <= h/2, writes Z[k] and Z[h-k] from the
// same two loads; W[h-k] = -conj(W[k]).
__global__ void irfft_tangle_kernel(const float2* __restrict__ x,
                                    float2* __restrict__ z, long long rows,
                                    int h) {
  const long long half = h / 2 + 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  const long long row = idx / half;
  const int k = (int)(idx - row * half);
  const float2* xr = x + row * (h + 1);
  float2* zr = z + row * h;
  float2 xa = xr[k], xb = xr[h - k];
  if (k == 0) {
    xa.y = 0.f;
    xb.y = 0.f;
  }
  float sn, cs;
  sincospif((float)k / (float)h, &sn, &cs);
  const float g = 0.5f / (float)h;
  // Z[k]: conj(X[h-k]) = (xb.x, -xb.y), W = (cs, sn).
  float2 ze = make_float2(g * (xa.x + xb.x), g * (xa.y - xb.y));
  float2 zo = cmul(make_float2(g * (xa.x - xb.x), g * (xa.y + xb.y)),
                   make_float2(cs, sn));
  zr[k] = make_float2(ze.x - zo.y, ze.y + zo.x);
  if (k == 0) return;
  // Z[h-k]: conj(X[k]) = (xa.x, -xa.y), W = (-cs, sn).
  ze = make_float2(g * (xb.x + xa.x), g * (xb.y - xa.y));
  zo = cmul(make_float2(g * (xb.x - xa.x), g * (xb.y + xa.y)),
            make_float2(-cs, sn));
  zr[h - k] = make_float2(ze.x - zo.y, ze.y + zo.x);
}

}  // namespace rc

// x (rows, h + 1) complex64 rfft bins of rows of n = 2h points -> z (rows,
// h), irfft's input to the backward h-point FFT, scaled by 1/h.
extern "C" int rc_irfft_tangle(const void* x, void* z, long long rows, int h,
                               void* stream) {
  if (rows < 1 || h < 2 || (h & (h - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = rows * (h / 2 + 1);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rc::irfft_tangle_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float2*)x, (float2*)z, rows, h);
  return (int)cudaGetLastError();
}

// z (rows, h) complex64, the FFT of the even/odd-packed real rows of n = 2h
// points -> x (rows, h + 1), their rfft.
extern "C" int rc_rfft_untangle(const void* z, void* x, long long rows, int h,
                                void* stream) {
  if (rows < 1 || h < 2 || (h & (h - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = rows * (h / 2 + 1);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rc::rfft_untangle_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const float2*)z, (float2*)x, rows, h);
  return (int)cudaGetLastError();
}
