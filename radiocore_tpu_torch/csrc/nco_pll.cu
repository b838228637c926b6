// K-NCO: the feedback NCO phase-locked loop of the 19 kHz stereo pilot, one
// sequential recurrence per row (station):
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
// What bounds it on an H100: neither bytes nor operations but the latency
// of the dependent chain of one sample (cosf, a multiply, four adds, a
// compare and a select), which no other sample of the row can overlap:
// 156 cycles a sample, 20.6 ms for a row of 262 144, measured on an NVIDIA
// H100 80GB HBM3 at 700 W and 1980 MHz (chip_smoke.py). The bytes (one
// read of x, one write of traj: 8 bytes a sample, 0.040 ms for 64 rows)
// are 0.2% of that, and rows are independent, so the time hardly depends
// on their number until they fill the card's warp slots.
//
// What the design does about it:
//  - One thread per row, the carried (phase, freq) in registers, 32 rows a
//    block: 64 stations are two warps on two SMs, and every warp has a
//    scheduler to itself.
//  - Loads and stores stay off the chain: a row goes by in tiles of 16
//    samples (four 16-byte loads), the next tile's loads started before the
//    current tile's samples are worked, so that device memory's latency
//    hides behind some sixteen chains; the trajectory leaves as 16-byte
//    streaming stores. A thread uses every byte of the 32-byte sectors it
//    touches, though a warp's accesses are a row apart. Rows that are not
//    16-byte aligned, and the ragged end, go sample by sample.
//  - The arithmetic is the scan's, operation for operation, in float32
//    round-to-nearest with no contraction into FMAs (__fmul_rn, __fadd_rn)
//    and `cosf`, not `__cosf`: the kernel and the plain PyTorch loop
//    (kernels/nco_pll.py `nco_pll_track_plain`) then round alike.
#include <cuda_runtime.h>

#include <cstdint>

namespace rc {

constexpr int kNcoThreads = 32;  // rows per block
constexpr int kNcoTile = 16;     // samples per tile, four 16-byte accesses

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

// One sample of the loop; returns the phase the detector saw.
__device__ __forceinline__ float nco_sample(float x, float& phase,
                                            float& freq, const NcoPll& p) {
  constexpr float kPi = 3.14159265358979323846f;
  constexpr float kTwoPi = 6.28318530717958647692f;
  const float seen = phase;
  const float err = __fmul_rn(x, cosf(phase));
  freq = __fadd_rn(freq, __fmul_rn(p.ki, err));
  phase = __fadd_rn(__fadd_rn(__fadd_rn(phase, p.w0), freq),
                    __fmul_rn(p.kp, err));
  if (phase > kPi) phase = __fsub_rn(phase, kTwoPi);
  return seen;
}

template <bool kVec>
__global__ void __launch_bounds__(kNcoThreads)
    nco_pll_kernel(const NcoPll p) {
  const long long row = (long long)blockIdx.x * kNcoThreads + threadIdx.x;
  if (row >= p.rows) return;
  const float* xr = p.x + row * p.x_stride;
  float* tr = p.traj + row * p.n;
  float phase = p.phase_in[row];
  float freq = p.freq_in[row];
  long long t = 0;
  if (kVec) {
    constexpr int kQuads = kNcoTile / 4;
    const long long tiles = p.n / kNcoTile;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* t4 = reinterpret_cast<float4*>(tr);
    float4 next[kQuads];
    if (tiles > 0) {
#pragma unroll
      for (int q = 0; q < kQuads; ++q) next[q] = __ldcs(x4 + q);
    }
    for (long long i = 0; i < tiles; ++i) {
      float4 cur[kQuads];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) cur[q] = next[q];
      if (i + 1 < tiles) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          next[q] = __ldcs(x4 + (i + 1) * kQuads + q);
        }
      }
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        float4 o;
        o.x = nco_sample(cur[q].x, phase, freq, p);
        o.y = nco_sample(cur[q].y, phase, freq, p);
        o.z = nco_sample(cur[q].z, phase, freq, p);
        o.w = nco_sample(cur[q].w, phase, freq, p);
        __stcs(t4 + i * kQuads + q, o);
      }
    }
    t = tiles * kNcoTile;
  }
  for (; t < p.n; ++t) tr[t] = nco_sample(xr[t], phase, freq, p);
  p.phase_out[row] = phase;
  p.freq_out[row] = freq;
}

}  // namespace rc

extern "C" int rc_nco_pll(const void* x, long long x_stride,
                          const void* phase_in, const void* freq_in,
                          void* traj, void* phase_out, void* freq_out,
                          long long rows, long long n, float kp, float ki,
                          float w0, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + rc::kNcoThreads - 1) / rc::kNcoThreads;
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
    rc::nco_pll_kernel<true><<<(unsigned)blocks, rc::kNcoThreads, 0, s>>>(p);
  } else {
    rc::nco_pll_kernel<false><<<(unsigned)blocks, rc::kNcoThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
