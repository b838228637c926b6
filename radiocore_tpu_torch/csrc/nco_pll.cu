// K-NCO: the feedback NCO phase-locked loop of the 19 kHz stereo pilot, one
// sequential recurrence per row (station). The JAX package's scan is
//
//   err    = x[t] * cos(phase)
//   traj[t] = phase                      (the phase the detector saw)
//   freq  += ki * err
//   phase  = ((phase + w0) + freq) + kp * err
//   phase  = phase > pi ? phase - 2 pi : phase
//
// Replaces no TPU kernel: the JAX package runs this loop as a `lax.scan`
// (radiocore_tpu/ops/nco_pll.py `nco_pll_track`, :53-77). In eager PyTorch
// the scan would be one Python iteration of a dozen tiny launches per
// sample, so on a CUDA tensor the loop is this kernel.
//
// Cycle counts below: NVIDIA H100 80GB HBM3 at 700 W and 1980 MHz
// (rc_nco_chain_probe, tools/nco_sweep.py, chip_smoke.py).
//
// What bounds it on an H100: neither bytes nor operations but the latency
// of the dependent chain of one sample, which no other sample of the row
// can overlap. The bytes (one read of x, one write of traj: 8 bytes a
// sample, 0.040 ms for 64 rows of 262 144) are a fraction of a percent of
// it, and rows are independent, so the time hardly depends on their
// number until they fill the card's warp slots. The scan's order puts
// cosf's range reduction and polynomial, a multiply, three adds, a
// multiply-add and the wrap's compare and select on that chain.
//
// What the design does about it:
//  - The recurrence is substituted so that the chain is one hardware
//    cosine and one fused multiply-add. With freq' = freq + ki*err put into
//    the phase update, and p the phase before its wrap (wrap(p) is the
//    scan's phase):
//
//      s   = (wrap(p) + w0) + f           ready before the cosine
//      c   = cos(p)                       the chain: FMUL (x 1/2pi), MUFU.COS
//      p'  = fma((ki + kp) * x, c, s)     the chain: one FFMA
//      f'  = fma(ki * x, c, f)
//      traj[t] = wrap(p);  state out: wrap(p), f
//
//    The products of x and the sum s do not depend on c: they are issued
//    while the cosine runs. rc_nco_chain_probe below times the bare chain,
//    the kernel's least time a sample (25.6 cycles; with the wrap in front
//    of the cosine 44.1, so the cosine takes the unwrapped phase).
//  - The cosine is the hardware one, __cosf, here only (kernels/build.py
//    keeps --use_fast_math off for every other source). Its absolute error
//    on [-pi, pi] is 2^-21.41; p lies in (-pi, pi + w0 + f + kp*err], and
//    past pi the error grows only as |p| * 6e-8 (the scaling by 1/2pi
//    rounds toward zero). A phase beyond 2 pi (a caller's initial phase, a
//    loop driven to a negative frequency) must take cosf, and a select
//    would wait for both and put cosf back on the chain; a branch a sample
//    kept the sums behind it (78 cycles a sample). So a tile goes on the
//    hardware cosine alone, noting whether a phase was beyond 2 pi, and
//    such a tile is done again from its first state with cosf by a branch:
//    the guard costs one branch a tile, off the chain.
//  - One thread per row, the carried (p, f) in registers. Every load and
//    store of a warp that holds a row a lane touches as many lines as it
//    has lanes, and those accesses queue in front of the cosines (the
//    hardware cosine is issued through the same memory-and-special-function
//    queue): so the rows are spread over the SMs' schedulers, a block of
//    one warp taking ceil(rows / (4 SMs)) rows rounded up to a power of
//    two (one row a block for 64 stations), 32 at most.
//  - Loads and stores stay off the chain: a row goes by in tiles of 48
//    samples, the next tile's loads started before the current tile's
//    samples are worked and the tile eight ahead prefetched into L2; the
//    trajectory leaves as streaming stores. A tile has a fixed cost (its
//    guard branch, addresses, loop): with 16 samples the kernel took 41.3
//    cycles a sample, 32 took 36.1, 48 took 33.8 and 64 (254 registers)
//    38.7. Rows on a 16-byte boundary move as 16-byte accesses, others as
//    scalar ones, loaded a tile ahead all the same; only the ragged end
//    (under 48 samples) goes sample by sample.
//
// The kernel does not round as the scan does: two float32 loops that round
// differently drift apart by about 1e-5 rad before the loop's feedback
// pulls them back. kernels/nco_pll.py `nco_pll_track_plain` keeps the
// scan's order; chip_smoke.py holds the kernel to it and to float64 with
// bounds that say so.
#include <cuda_runtime.h>

#include <cstdint>

namespace rc {

constexpr int kNcoThreads = 32;  // rows per block, at most
constexpr int kNcoTile = 48;     // samples per tile
constexpr int kNcoAhead = 8;     // tiles between a row's L2 prefetch and use
constexpr float kNcoPi = 3.14159265358979323846f;
constexpr float kNcoTwoPi = 6.28318530717958647692f;

struct NcoPll {
  const float* x;  // (rows, n), rows x_stride apart
  long long x_stride;
  const float* phase_in;  // (rows,)
  const float* freq_in;   // (rows,)
  float* traj;            // (rows, n), contiguous
  float* phase_out;       // (rows,)
  float* freq_out;        // (rows,)
  long long rows;
  long long n;
  float kp, ki, w0;
};

// One sample; returns the phase the detector saw (the scan's phase, wrap(p)).
// kk = ki + kp. kGuard: the cosine beyond 2 pi is cosf, by a branch;
// without it the sample only notes in `far` that __cosf was given such a
// phase.
template <bool kGuard>
__device__ __forceinline__ float nco_sample(float x, float& p, float& f,
                                            float kk, float ki, float w0,
                                            bool& far) {
  const float seen = p > kNcoPi ? __fsub_rn(p, kNcoTwoPi) : p;
  const float s = __fadd_rn(__fadd_rn(seen, w0), f);
  const float a = __fmul_rn(kk, x);
  const float b = __fmul_rn(ki, x);
  float c = __cosf(p);
  if (kGuard) {
    if (fabsf(p) > kNcoTwoPi) c = cosf(p);
  } else {
    far |= fabsf(p) > kNcoTwoPi;
  }
  p = __fmaf_rn(a, c, s);
  f = __fmaf_rn(b, c, f);
  return seen;
}

// kN samples from (p, f): all on the hardware cosine, and if one of them
// met a phase beyond 2 pi (a wild initial phase; no sample of a locked
// loop), all again from the same state with the guard. The guard's branch
// is taken once a tile, off the samples' chain.
template <int kN>
__device__ __forceinline__ void nco_tile(const float (&x)[kN],
                                         float (&out)[kN], float& p,
                                         float& f, float kk, float ki,
                                         float w0) {
  const float p0 = p;
  const float f0 = f;
  bool far = false;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    out[j] = nco_sample<false>(x[j], p, f, kk, ki, w0, far);
  }
  if (far) {
    p = p0;
    f = f0;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      out[j] = nco_sample<true>(x[j], p, f, kk, ki, w0, far);
    }
  }
}

// A tile: 16-byte accesses (kVec) or scalar ones.
template <bool kVec>
__device__ __forceinline__ void nco_load_tile(const float* src,
                                              float (&v)[kNcoTile]) {
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < kNcoTile / 4; ++q) {
      const float4 t = __ldcs(s4 + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNcoTile; ++j) v[j] = __ldcs(src + j);
  }
}

template <bool kVec>
__device__ __forceinline__ void nco_store_tile(float* dst,
                                               const float (&v)[kNcoTile]) {
  if (kVec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int q = 0; q < kNcoTile / 4; ++q) {
      __stcs(d4 + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                 v[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNcoTile; ++j) __stcs(dst + j, v[j]);
  }
}

// Rows a block (one warp): the rows spread over the SMs' schedulers, four
// an SM, a power of two.
inline int nco_lanes(long long rows, int sms) {
  const long long warps = 4LL * (sms > 0 ? sms : 1);
  const long long per_warp = (rows + warps - 1) / warps;
  int lanes = 1;
  while (lanes < kNcoThreads && lanes < per_warp) lanes *= 2;
  return lanes;
}

template <bool kVec>
__global__ void __launch_bounds__(kNcoThreads)
    nco_pll_kernel(const NcoPll prm) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= prm.rows) return;
  const float* xr = prm.x + row * prm.x_stride;
  float* tr = prm.traj + row * prm.n;
  const float kk = __fadd_rn(prm.ki, prm.kp);
  const float ki = prm.ki;
  const float w0 = prm.w0;
  float p = prm.phase_in[row];
  float f = prm.freq_in[row];
  const long long tiles = prm.n / kNcoTile;
  float next[kNcoTile];
  if (tiles > 0) nco_load_tile<kVec>(xr, next);
  for (long long i = 0; i < tiles; ++i) {
    float cur[kNcoTile];
#pragma unroll
    for (int j = 0; j < kNcoTile; ++j) cur[j] = next[j];
    if (i + 1 < tiles) nco_load_tile<kVec>(xr + (i + 1) * kNcoTile, next);
    if (i + kNcoAhead < tiles) {
      asm volatile("prefetch.global.L2 [%0];"
                   :
                   : "l"(xr + (i + kNcoAhead) * kNcoTile));
    }
    float out[kNcoTile];
    nco_tile(cur, out, p, f, kk, ki, w0);
    nco_store_tile<kVec>(tr + i * kNcoTile, out);
  }
  bool far = false;
  for (long long t = tiles * kNcoTile; t < prm.n; ++t) {
    tr[t] = nco_sample<true>(xr[t], p, f, kk, ki, w0, far);
  }
  prm.phase_out[row] = p > kNcoPi ? __fsub_rn(p, kNcoTwoPi) : p;
  prm.freq_out[row] = f;
}

// The measuring aid behind rc_nco_chain_probe: each thread runs n links of
// a chain with x and the constants in registers, no loads or stores, and
// writes its phase and the SM cycles the loop took once at the end.
//   kChain 0: the bare chain, p = fma(a, __cosf(p), s)
//   kChain 1: the same with the wrap on the chain, __cosf(wrap(p))
//   kChain 2: the kernel's tiles (nco_tile, the guard included), n / 48
//             of them
template <int kChain>
__global__ void nco_chain_probe_kernel(float* result, long long* cycles,
                                       long long n, float x, float kp,
                                       float ki, float w0) {
  const float kk = __fadd_rn(ki, kp);
  const float a = __fmul_rn(kk, x);
  const float s = w0;
  float p = 0.01f * threadIdx.x;
  float f = 0.0f;
  const long long t0 = clock64();
  if (kChain == 2) {
    float xs[kNcoTile];
    float out[kNcoTile];
#pragma unroll
    for (int j = 0; j < kNcoTile; ++j) xs[j] = x;
    for (long long i = 0; i < n / kNcoTile; ++i) {
      nco_tile(xs, out, p, f, kk, ki, w0);
    }
  } else {
#pragma unroll 16
    for (long long i = 0; i < n; ++i) {
      const float in = kChain == 0 || p <= kNcoPi ? p
                                                  : __fsub_rn(p, kNcoTwoPi);
      p = __fmaf_rn(a, __cosf(in), s);
    }
  }
  const long long t1 = clock64();
  result[threadIdx.x] = p + f;
  cycles[threadIdx.x] = t1 - t0;
}

}  // namespace rc

extern "C" int rc_nco_pll(const void* x, long long x_stride,
                          const void* phase_in, const void* freq_in,
                          void* traj, void* phase_out, void* freq_out,
                          long long rows, long long n, float kp, float ki,
                          float w0, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int lanes = rc::nco_lanes(rows, sms);
  const long long blocks = (rows + lanes - 1) / lanes;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rc::NcoPll p;
  p.x = (const float*)x;
  p.x_stride = x_stride;
  p.phase_in = (const float*)phase_in;
  p.freq_in = (const float*)freq_in;
  p.traj = (float*)traj;
  p.phase_out = (float*)phase_out;
  p.freq_out = (float*)freq_out;
  p.rows = rows;
  p.n = n;
  p.kp = kp;
  p.ki = ki;
  p.w0 = w0;
  // 16-byte accesses need every row of x and of traj on a 16-byte boundary.
  const bool vec = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(traj) & 15) == 0) &&
                   (x_stride % 4 == 0) && (n % 4 == 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    rc::nco_pll_kernel<true><<<(unsigned)blocks, lanes, 0, s>>>(p);
  } else {
    rc::nco_pll_kernel<false><<<(unsigned)blocks, lanes, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// K-NCO's latency bound: one block of `lanes` threads (1..32), each running
// `n` links of chain `chain` (see nco_chain_probe_kernel); `result` and
// `cycles` take one value per lane. A measuring aid: no path calls it.
extern "C" int rc_nco_chain_probe(void* result, void* cycles, long long n,
                                  int chain, int lanes, float x, float kp,
                                  float ki, float w0, void* stream) {
  if (n < 1 || lanes < 1 || lanes > 32) return (int)cudaErrorInvalidValue;
  float* r = (float*)result;
  long long* c = (long long*)cycles;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (chain) {
    case 0:
      rc::nco_chain_probe_kernel<0><<<1, lanes, 0, s>>>(r, c, n, x, kp, ki,
                                                        w0);
      break;
    case 1:
      rc::nco_chain_probe_kernel<1><<<1, lanes, 0, s>>>(r, c, n, x, kp, ki,
                                                        w0);
      break;
    case 2:
      rc::nco_chain_probe_kernel<2><<<1, lanes, 0, s>>>(r, c, n, x, kp, ki,
                                                        w0);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
