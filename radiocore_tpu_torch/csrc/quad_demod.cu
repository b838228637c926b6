// K-QDEMOD: the quadrature (FM) demod of complex64 rows in one pass.
// For each row, quad[0] = 0 and quad[t] = gain * atan2f(Im d, Re d) for
// t >= 1, where d = 0 + x[t] * conj(x[t - 1]).
//
// Replaces no TPU kernel: the reference's demod is jnp ops
// (radiocore_tpu/ops/demod.py, quadrature_demod), which XLA fuses. In
// torch the same function was five passes over the station IQ (a
// materialised conj, addcmul, angle, the product by the gain and
// F.pad's copy), about 390 MB of traffic at 24 x 240 000 points; that
// chain stays as the plain version (kernels/quad_demod.py
// quad_demod_plain), which a CPU tensor runs.
//
// The arithmetic is the plain version's, but for how the complex product
// contracts into FMAs (torch's rounds apart from this one's in about a
// third of the samples, by an ulp or two of the angle):
//  - the product is formed onto +0 (0 + x * conj(p)), which turns a -0
//    part into +0, so that a dead station (zeros of either sign, as an
//    extraction kernel writes them) demodulates to 0 and not to +-pi;
//  - the angle is atan2f, the function torch's angle calls (not
//    extract_demod.cu's atan2_fast, which is up to 2e-6 rad away);
//  - the gain multiplies the angle in float32 afterwards.
//
// What bounds it on an H100: by the bytes it must move, device memory:
// each IQ point read once (8 B) and each quad sample written once (4 B),
// 69 MB and 0.021 ms at 24 x 240 000 points. atan2f, with its division,
// is some forty instructions a sample on its fast path: about a third of
// that time at the card's instruction rate.
//
// What the design does about it:
//  - A thread takes kSamples consecutive samples of a row, a block
//    kTile, side by side, so that a warp reads 1 KB of neighbouring IQ
//    and writes 512 neighbouring bytes of quad. Where every row is 16-byte
//    aligned (the base, an even row stride, a length that is a multiple
//    of kSamples) the thread reads its samples by two 16-byte loads and
//    writes its quads by one 16-byte store; otherwise (an odd length, a
//    row slice off a 16-byte boundary) it takes 8-byte loads and 4-byte
//    stores, each masked at the row's end.
//  - The predecessor of a thread's first sample is the last sample of the
//    lane before it, taken by a shuffle. Lane 0 loads it, together with
//    its own samples, so that a warp waits for device memory once.
//  - The IQ is read evict-first (nothing reads it again); the quad is a
//    default store, since the station rfft reads it next from the L2
//    (written evict-first, it slowed that rfft, at 8 rows by more than
//    the demod's own time).
//  - Rows and tiles are one flat grid, so any number of rows fills the
//    132 SMs: 1 880 blocks at 8 rows of 240 000, 5 640 at 24.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSamples = 4;                  // consecutive samples a thread
constexpr int kTile = kThreads * kSamples;   // samples a block

static_assert(kSamples == 4, "two 16-byte loads and one 16-byte store");

// gain * angle(0 + x * conj(p)), the product as torch's complex multiply
// writes it.
__device__ __forceinline__ float quad(float2 x, float2 p, float gain) {
  const float cy = -p.y;
  const float re = 0.f + (x.x * p.x - x.y * cy);
  const float im = 0.f + (x.x * cy + x.y * p.x);
  return atan2f(im, re) * gain;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    quad_demod_kernel(const float2* __restrict__ x, long long x_stride,
                      float* __restrict__ y, long long n, unsigned tiles,
                      float gain) {
  const unsigned row = blockIdx.x / tiles;
  const unsigned tile = blockIdx.x - row * tiles;
  const float2* xr = x + (long long)row * x_stride;
  float* yr = y + (long long)row * n;
  const long long t0 =
      (long long)tile * kTile + (long long)threadIdx.x * kSamples;
  const bool lane0 = (threadIdx.x & 31) == 0;

  float2 s[kSamples];
  const float2 zero = make_float2(0.f, 0.f);
  if (kVec) {
    // n is a multiple of kSamples: a thread's samples lie all inside the
    // row or all past its end.
    if (t0 < n) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(xr + t0));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(xr + t0 + 2));
      s[0] = make_float2(a.x, a.y);
      s[1] = make_float2(a.z, a.w);
      s[2] = make_float2(b.x, b.y);
      s[3] = make_float2(b.z, b.w);
    } else {
#pragma unroll
      for (int k = 0; k < kSamples; ++k) s[k] = zero;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSamples; ++k) {
      s[k] = t0 + k < n ? __ldcs(xr + t0 + k) : zero;
    }
  }
  const float2 before = (lane0 && t0 > 0 && t0 < n) ? xr[t0 - 1] : zero;

  // Every lane of the warp takes part, those past the row's end too.
  float2 p;
  p.x = __shfl_up_sync(0xffffffffu, s[kSamples - 1].x, 1);
  p.y = __shfl_up_sync(0xffffffffu, s[kSamples - 1].y, 1);
  if (lane0) p = before;

  float q[kSamples];
  q[0] = t0 == 0 ? 0.f : quad(s[0], p, gain);
#pragma unroll
  for (int k = 1; k < kSamples; ++k) q[k] = quad(s[k], s[k - 1], gain);

  if (kVec) {
    if (t0 < n) {
      *reinterpret_cast<float4*>(yr + t0) =
          make_float4(q[0], q[1], q[2], q[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSamples; ++k) {
      if (t0 + k < n) yr[t0 + k] = q[k];
    }
  }
}

}  // namespace

// K-QDEMOD: x (rows, n) complex64, row r at x + r * x_stride points, with
// unit stride along a row -> y (rows, n) float32, contiguous. The 16-byte
// path where x is 16-byte aligned, every row starts on a 16-byte boundary
// (an even x_stride, or one row) and n is a multiple of 4, with y 16-byte
// aligned; 8-byte loads otherwise. Ordered on `stream`. Returns a
// cudaError_t.
extern "C" int rc_quad_demod(const void* x, long long x_stride, void* y,
                             long long rows, long long n, float gain,
                             void* stream) {
  if (rows < 1 || n < 1 || (reinterpret_cast<uintptr_t>(y) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 7) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (n + kTile - 1) / kTile;
  const long long blocks = rows * tiles;
  if (tiles > 0xffffffffLL || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0 &&
                   (rows == 1 || x_stride % 2 == 0) && n % kSamples == 0;
  const auto kernel =
      vec ? quad_demod_kernel<true> : quad_demod_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, x_stride, (float*)y, n, (unsigned)tiles, gain);
  return (int)cudaGetLastError();
}
