// K-GATHER: the extraction's reorder for any plan, every station in one
// launch: spectrum rows (bands, n) -> out (rows, m), in the output order
// [pos, neg] of ops/channelize's reorder, windowed and scaled, each row's
// run from its own spectrum row and start. One plan over a batch of
// spectra is the case at[b * C + c] = b * n + starts[c].
//
// Replaces no TPU kernel. The reference lowers the per-slice extraction
// (radiocore_tpu/ops/channelize.py, make_extractor's slice lowering) to
// XLA slices and gathers; in torch the same reorder was a copy of the
// whole spectrum for the wrap, a cat, a window multiply and a two-kernel
// fold of the fix bin per station, a stack and a divide: about 100
// kernels that only move bytes. K-EXTRACT (extract.cu) covers the
// uniform power-of-two plans alone; this kernel takes the rest.
//
// Row r's run is the m + lead bins of spectrum row at[r] / n from bin
// at[r] mod n, mod n (lead = 1 for an even m: the fix bin comes first).
// Output j < m2 (= m/2 + 1) is run bin lead + neg + j, output j >= m2 is
// run bin lead + j - m2 (neg = m - m2), each times win[j] (the hann of
// extraction_plan in output order with the extraction's whole scale
// folded in: 1/s_fac and the inverse transform's 1/m, so that neither
// takes a pass). For an even m, output m2 - 1 also adds run bin 0 times
// `fix`. Every product and that one sum are rounded on their own (no
// contraction into an FMA), as the plain version (kernels/extract.py
// extract_gather_rows_plain) computes them.
//
// What bounds it on an H100: by the bytes it must move, device memory:
// each station's m bins read once and its m IQ points written once, 16 B
// a point (92 MB, 0.0275 ms, for 24 stations of 240 000 points). It does
// one multiply per float moved.
//
// What the design does about it: the grid is (blocks along a row, rows).
// A thread takes kPairs output pairs at even flat positions of the
// output, a block's threads side by side, so that each pair leaves as one
// 16-byte store and a warp's stores cover 512 neighbouring bytes. A
// pair's two bins lie next to each other in the spectrum except at the
// join of the two halves, at the spectrum's end, and for a row that
// starts at an odd flat position (odd m); they come as one 16-byte load
// where the first lies at an even bin of a 16-byte aligned row, as two
// 8-byte loads otherwise. Every load of a thread is issued before its
// first multiply, so a thread keeps kPairs * 16 bytes in flight (128 KB
// an SM at 2048 threads). The spectrum is read evict-first (no one reads
// it again); the output is a default store, since the inverse transform
// reads it next. The window table (4 bytes a point, shared by every
// station) stays in the L2.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace rc {

// One launch's plan, by value. Declared in rc and not in an unnamed
// namespace: nvcc's host stub must name the type.
struct GatherPlan {
  long long n;  // bins of a spectrum row
  int rows;     // output rows, one a station of a spectrum row
  int m;        // points a station
  int m2;       // m / 2 + 1: outputs taken from the run's upper part
  int neg;      // m - m2
  int lead;     // 1 for an even m (the fix bin first), else 0
  float fix;    // even m: the fix bin's weight, scale folded in
};

}  // namespace rc

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4;  // output pairs a thread
constexpr int kBlockPairs = kThreads * kPairs;
constexpr int kMaxGridY = 65535;

// The spectrum bin of output j of the run that starts at bin `start`.
__device__ __forceinline__ long long run_bin(const rc::GatherPlan& p,
                                             long long start, int j) {
  const long long i = start + p.lead + (j < p.m2 ? p.neg + j : j - p.m2);
  return i < p.n ? i : i - p.n;
}

__device__ __forceinline__ float2 times(float2 v, float w) {
  return make_float2(__fmul_rn(v.x, w), __fmul_rn(v.y, w));
}

// v + x * w, the product rounded before the sum.
__device__ __forceinline__ float2 fold(float2 v, float2 x, float w) {
  return make_float2(__fadd_rn(v.x, __fmul_rn(x.x, w)),
                     __fadd_rn(v.y, __fmul_rn(x.y, w)));
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float2* __restrict__ spec, float2* __restrict__ out,
                  const long long* __restrict__ at,
                  const float* __restrict__ win, const rc::GatherPlan p) {
  for (int row = blockIdx.y; row < p.rows; row += gridDim.y) {
    const long long b = at[row] / p.n;  // at[row] = spectrum row * n + start
    const float2* sp = spec + b * p.n;
    const long long start = at[row] - b * p.n;
    const bool vec = (reinterpret_cast<uintptr_t>(sp) & 15) == 0;
    const long long base = (long long)row * p.m;  // flat index of output 0
    // Pair k holds outputs j = 2k - lag and j + 1, at even flat positions.
    const int lag = (int)(base & 1);
    const int pairs = (p.m + 1 + lag) >> 1;
    const int k0 = blockIdx.x * kBlockPairs + threadIdx.x;
    float2 lo[kPairs], hi[kPairs];
    float wlo[kPairs], whi[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int k = k0 + u * kThreads;
      const int j = 2 * k - lag;
      lo[u] = hi[u] = make_float2(0.f, 0.f);
      wlo[u] = whi[u] = 0.f;
      if (k >= pairs) continue;
      const bool has_lo = j >= 0, has_hi = j + 1 < p.m;
      if (has_lo && has_hi && j + 1 != p.m2) {  // both in one half
        const long long i = run_bin(p, start, j);
        if (vec && !(i & 1) && i + 1 < p.n) {
          const float4 q = __ldcs(reinterpret_cast<const float4*>(sp + i));
          lo[u] = make_float2(q.x, q.y);
          hi[u] = make_float2(q.z, q.w);
        } else {
          lo[u] = __ldcs(sp + i);
          hi[u] = __ldcs(sp + (i + 1 < p.n ? i + 1 : 0));
        }
      } else {
        if (has_lo) lo[u] = __ldcs(sp + run_bin(p, start, j));
        if (has_hi) hi[u] = __ldcs(sp + run_bin(p, start, j + 1));
      }
      if (has_lo && has_hi && !(j & 1)) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(win + j));
        wlo[u] = w.x;
        whi[u] = w.y;
      } else {
        if (has_lo) wlo[u] = __ldg(win + j);
        if (has_hi) whi[u] = __ldg(win + j + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int k = k0 + u * kThreads;
      const int j = 2 * k - lag;
      if (k >= pairs) continue;
      float2 a = times(lo[u], wlo[u]);
      float2 c = times(hi[u], whi[u]);
      if (p.lead && j == p.m2 - 1) a = fold(a, sp[start], p.fix);
      if (p.lead && j + 1 == p.m2 - 1) c = fold(c, sp[start], p.fix);
      float2* o = out + base + j;
      if (j >= 0 && j + 1 < p.m) {
        *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, c.x, c.y);
      } else if (j >= 0) {
        *o = a;
      } else {
        o[1] = c;
      }
    }
  }
}

}  // namespace

// K-GATHER: spectra (bands, n) -> out (rows, m), row r's run from bin
// at[r] mod n of spectrum row at[r] / n (at: `rows` int64, each in
// [0, bands * n)), times win (m float32, output order); an even m folds
// the fix bin with weight `fix`. `out` must be 16-byte aligned and `win`
// 8-byte aligned; a spectrum row that is not 16-byte aligned takes 8-byte
// loads. Ordered on `stream`. Returns a cudaError_t.
extern "C" int rc_extract_gather(const void* spectra, void* out,
                                 const void* at, const void* win,
                                 long long n, long long rows, long long m,
                                 float fix, void* stream) {
  const long long lead = (m % 2 == 0) ? 1 : 0;
  if (m < 1 || m > INT_MAX / 2 || m + lead > n || rows < 1 ||
      rows > INT_MAX || (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(win) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  rc::GatherPlan p;
  p.n = n;
  p.rows = (int)rows;
  p.m = (int)m;
  p.m2 = (int)(m / 2 + 1);
  p.neg = p.m - p.m2;
  p.lead = (int)lead;
  p.fix = fix;
  const unsigned gx = (unsigned)((m / 2 + 1 + kBlockPairs - 1) / kBlockPairs);
  const unsigned gy = (unsigned)(p.rows < kMaxGridY ? p.rows : kMaxGridY);
  gather_kernel<<<dim3(gx, gy), kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)spectra, (float2*)out, (const long long*)at,
      (const float*)win, p);
  return (int)cudaGetLastError();
}
