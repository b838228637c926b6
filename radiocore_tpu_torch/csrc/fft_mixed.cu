// K-MIXED: the column pass of one long FFT of n = a*b points, a <= 128 and
// possibly not a power of two (the 96-station band: n = 96 * 2^18), b a
// power of two.
//
// Replaces radiocore_tpu/kernels/fft_pallas.py `fft_large_mixed_pallas`
// -> `_four_step_pallas` (the XLA-level a-point column DFT `_cmm_nd`, the
// twiddle, the `_fft_call` rows and the final transpose). With
// j = b*j1 + j2 and k = k1 + a*k2:
//     T[k1, j2] = W_n^(k1*j2) * sum_j1 x[b*j1 + j2] W_a^(j1*k1)   (here)
//     X[k1 + a*k2] = sum_j2 T[k1, j2] W_b^(j2*k2)                  (rows)
// The rows are K-FFT's passes (rc_fft_pass, fft_rows.cu), planned by
// kernels/fft_mixed.py so that their last pass stores element k2 of row k1
// straight at k1 + a*k2: natural order, no transpose pass.
//
// What bounds it on an H100: the direct a-point DFT does a complex
// multiply-add per (j1, k1) pair, 4*a flops per point per output: about
// 19 GFLOP at n = 24M, a = 96, against 2 x 201 MB of traffic. It is
// compute-bound, and a radix-3*32 split is the way to cut it (a later
// change); a direct DFT per thread group is the simple form that is right.
//
// What the design does about it: a block stages a tile of kColTile
// neighbouring columns (all a rows, coalesced 256-byte runs) in shared
// memory; thread (tx, ty) owns column tx and the outputs k1 = ty + 8*r,
// holding their sums in registers, and reads the a-point table
// W_a^((j1*k1) mod a), whose index it steps by k1 mod a with no division.
// The twiddle index k1*j2 < n needs no reduction beyond the 64-bit product;
// n is not a power of two, so 2*r/n is not exact in float32 and the phase
// is taken with sincospi in double, then rounded once to float.
#include <cuda_runtime.h>

namespace {

constexpr int kColTile = 32;    // columns j2 per block (one warp wide)
constexpr int kColGroups = 8;   // warps per block; k1 = ty + kColGroups*r
constexpr int kMaxA = 128;
constexpr int kMaxR = kMaxA / kColGroups;

__global__ void __launch_bounds__(kColTile * kColGroups)
    mixed_column_kernel(const float2* __restrict__ in,
                        float2* __restrict__ out, int a, long long b,
                        float sign) {
  __shared__ float2 tile[kMaxA][kColTile];
  __shared__ float2 wa[kMaxA];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kColTile + tx;
  const long long j2 = (long long)blockIdx.x * kColTile + tx;
  const long long n = (long long)a * b;

  for (int e = tid; e < a; e += kColTile * kColGroups) {
    double sn, cs;
    sincospi(2.0 * (double)e / (double)a, &sn, &cs);
    wa[e] = make_float2((float)cs, sign * (float)sn);
  }
  for (int j1 = ty; j1 < a; j1 += kColGroups) {
    tile[j1][tx] = (j2 < b) ? in[(long long)j1 * b + j2]
                            : make_float2(0.f, 0.f);
  }
  __syncthreads();

  float2 acc[kMaxR];
  int idx[kMaxR];  // (j1 * k1) mod a for the current j1
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    acc[r] = make_float2(0.f, 0.f);
    idx[r] = 0;
  }
  for (int j1 = 0; j1 < a; ++j1) {
    const float2 x = tile[j1][tx];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int k1 = ty + kColGroups * r;
      if (k1 < a) {  // uniform across the warp
        const float2 w = wa[idx[r]];
        acc[r].x = fmaf(x.x, w.x, fmaf(-x.y, w.y, acc[r].x));
        acc[r].y = fmaf(x.x, w.y, fmaf(x.y, w.x, acc[r].y));
        idx[r] += k1;
        if (idx[r] >= a) idx[r] -= a;
      }
    }
  }
  if (j2 >= b) return;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int k1 = ty + kColGroups * r;
    if (k1 < a) {
      const long long rr = (long long)k1 * j2;  // < (a-1)*(b-1) < n
      double sn, cs;
      sincospi(2.0 * (double)rr / (double)n, &sn, &cs);
      const float wr = (float)cs, wi = sign * (float)sn;
      const float2 v = acc[r];
      out[(long long)k1 * b + j2] =
          make_float2(v.x * wr - v.y * wi, v.x * wi + v.y * wr);
    }
  }
}

}  // namespace

// Column pass: x (a, b) row-major -> T (a, b) row-major, both complex64.
extern "C" int rc_mixed_column(const void* in, void* out, int a, long long b,
                               int sign, void* stream) {
  if (a < 2 || a > kMaxA || b < 1 || (b & (b - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (b + kColTile - 1) / kColTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 threads(kColTile, kColGroups);
  mixed_column_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)in, (float2*)out, a, b, sign < 0 ? -1.0f : 1.0f);
  return (int)cudaGetLastError();
}
