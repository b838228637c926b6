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
// It carries the NCO as the phasor w = sqrt(2) e^{jp} in place of p:
//
//   cos p  = Re w / sqrt(2)              the detector's cosine, free
//   psi    = fma(a, Re w, f)             a = (kp + ki) s_row x / sqrt(2)
//   f'     = fma(b, Re w, f)             b = ki s_row x / sqrt(2)
//   out[t] = -Re w Im w                  -sin 2p, the subcarrier, or
//            atan2(Im w, Re w)           p, the phase (kNcoPhase)
//   w'     = (w e^{jw0}) e^{jpsi}
//
// with s_row the row's 1 / RMS (the stereo decoder's pilot is read as the
// bandpass gives it; the trajectory's caller passes 1), and the gains over
// sqrt(2) and e^{jw0} = (cw, sw) rounded once from float64 on the host.
// The length sqrt(2) makes the subcarrier one product. The subcarrier is
// what the `nco` step runs (ops/nco_pll.py `nco_pll_subcarrier`); the phase
// is `nco_pll_track`'s trajectory on the card, on no path of the system.
// The phase output's first sample is the phase the caller gave, as the
// scan's is (the atan2 of its phasor would round it).
//
// What bounds it on an H100: neither bytes nor operations but the latency
// of the dependent chain of one sample, which no other sample of the row
// can overlap; rows are independent, so the time hardly depends on their
// number until they fill the card's warp slots. In the loop |psi| is about
// 1e-3 rad (the gains of a 50 Hz loop at 240 kS/s sum to 5.9e-4, the
// normalised pilot peaks near 1.5), so e^{jpsi} is 1 - psi^2 / 2 + j psi
// to within 2^-26 for every |psi| up to kNcoPsiMax = 2^-8 (the series'
// error is psi^3 / 6). With u = w e^{jw0} and h = psi / 2 it is applied as
//
//   Re w' = fma(-psi, fma(h, Re u, Im u), Re u)
//   Im w' = fma(psi, fma(-h, Im u, Re u), Im u)
//
// so the chain is four dependent FP32 operations (psi, h, the inner and
// the outer multiply-add: 16 cycles), and u, which needs w only, is ready
// by the time h is. A sample is 15 instructions (two products of x, psi
// and f, the subcarrier's product, u's four, the series' five, one max),
// issued one at a time by the row's one warp: measured (NVIDIA H100 80GB
// HBM3, 700 W, 1980 MHz; rc_nco_chain_probe) the bare recurrence takes
// 21.5 cycles a sample and the whole sample without loads and stores
// 21.9; in the kernel, at 24 x 240 000, 26.9 (3.26 ms). No MUFU is left on
// the subcarrier's fast path.
//
// What the design does about it:
//  - The series is checked a tile at a time, off the chain: each sample
//    folds |psi| into a running max, and a tile whose max passed
//    kNcoPsiMax (a wide loop, a pilot with spikes, an acquisition far off
//    19 kHz) is done again from its first state with the exact rotation
//    (sincosf) by one branch a tile, and counted on the caller's device
//    counter (`redone`, one atomic add a redone tile), so that a graph's
//    replays count too. The redo (phasor_redo) is out of line: it reads
//    the tile's pilot back and writes its output again by pointer, so the
//    fast path's code stays in one piece. A phase beyond 2 pi (a caller's
//    initial phase) needs no guard: the phasor has no phase to wrap.
//  - |w| drifts by the rounding of each rotation (about 1e-7 a sample)
//    and is brought back to sqrt(2) once a tile by one Newton step,
//    g = 1.5 - |w|^2 / 4.
//  - One thread per row, the carried (w, f) in registers. Every load and
//    store of a warp that holds a row a lane touches as many lines as it
//    has lanes, so the rows are spread over the SMs' schedulers, a block of
//    one warp taking ceil(rows / (4 SMs)) rows rounded up to a power of
//    two (nco_lanes; one row a block for 24 or 64 stations), 32 at most.
//    Every lane of a warp working the same row with lane q keeping quad q
//    of the output (one store a tile), or a rolled loop with the pilot
//    shuffled from the lanes, measured no faster (30.8 and 35.7 cycles a
//    sample at 96 and 32 samples a group).
//  - Loads and stores stay off the chain: rows on a 16-byte boundary move
//    as 16-byte accesses, others as scalar ones; the next tile's loads are
//    started before the current tile's samples are worked, the tile eight
//    ahead is prefetched into L2, and each quad of the output leaves by a
//    streaming store as soon as it is worked. A tile is 80 samples
//    (kNcoPhasorTile): by measurement at 24 x 240 000 the time a sample
//    went 32.0, 30.4, 30.0, 30.9, 26.7, 26.6, 28.5, 29.7, 30.2 cycles at
//    48, 40, 64, 72, 80, 88, 96, 104, 112 samples a tile; two tiles a
//    loop with no copy between them, or one buffer filled from L1 after
//    an L1 prefetch, were slower (31.8 to 44.2). Only the ragged end
//    (under 80 samples) goes sample by sample.
//  - The state crosses chunks as the phase: w = sqrt(2) e^{j phase_in} by
//    sincosf at the start, phase_out = atan2f(Im w, Re w) at the end, in
//    (-pi, pi] as the scan's wrapped phase is.
//
// The kernel does not round as the scan does: the scan carries the phase
// in float32 and rounds it at every sum, the kernel carries w. On the
// CPU, over rms-normalised pilots, the scan's float32 trajectory drifts up
// to about 1e-4 rad from a float64 loop while it acquires, the phasor's
// plain loop a few 1e-6. kernels/nco_pll.py `nco_pll_phasor_plain` is the
// kernel's arithmetic in float32 with the rows as the vector.
#include <cuda_runtime.h>

#include <cstdint>

namespace rc {

constexpr int kNcoThreads = 32;  // rows per block, at most
constexpr int kNcoAhead = 8;     // tiles between a row's L2 prefetch and use
// The series limit: (1 - psi^2 / 2, psi) is e^{jpsi} to within 2^-26 for
// |psi| <= 2^-8.
constexpr float kNcoPsiMax = 0.00390625f;
constexpr int kNcoPhasorTile = 80;  // samples a tile

// What a sample writes (the C entry's `output`).
constexpr int kNcoSubcarrier = 0;  // -sin 2p = -Re w Im w
constexpr int kNcoPhase = 1;       // p = atan2(Im w, Re w), nco_phase

// A tile of the pilot: 16-byte accesses (kVec) or scalar ones.
template <bool kVec, int kN>
__device__ __forceinline__ void nco_load_tile(const float* src,
                                              float (&v)[kN]) {
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      const float4 t = __ldcs(s4 + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = __ldcs(src + j);
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

struct NcoPhasor {
  const float* x;  // (rows, n), rows x_stride apart: the pilot
  long long x_stride;
  const float* scale;     // (rows,) 1 / RMS of the row, or 1
  const float* phase_in;  // (rows,)
  const float* freq_in;   // (rows,)
  float* out;             // (rows, n), contiguous: what kOut says
  float* phase_out;       // (rows,)
  float* freq_out;        // (rows,)
  unsigned long long* redone;  // tiles done again with sincosf
  long long rows;
  long long n;
  float ak, ai;  // (ki + kp) / sqrt(2) and ki / sqrt(2), float32
  float cw, sw;  // e^{j w0}
};

// The rotation e^{jpsi} of one sample: kPhasorSeries (1 - psi^2 / 2, psi),
// folding |psi| into m; kPhasorExact sincosf; kPhasorEither the series
// below kNcoPsiMax and sincosf above it, sample by sample (the ragged end).
constexpr int kPhasorSeries = 0;
constexpr int kPhasorExact = 1;
constexpr int kPhasorEither = 2;

// The phase output's atan2(Im w, Re w), branch-free. |w| is sqrt(2) to
// within the renormalisation, so the ratio of the smaller part to the
// larger needs no special case and no IEEE division (whose slow path, a
// branch and a call a sample, held atan2f to 270 cycles a sample):
// z = lo / hi by __fdividef, atan(z) = z + z^3 Q(z^2) with Q the degree-5
// minimax fit on [0, 1] of extract_demod.cu's atan2_fast (within 2e-6 rad
// of atan2), then the octant and the quadrant by selects. NaN stays NaN.
__device__ __forceinline__ float nco_phase(float wr, float wi) {
  const float ax = fabsf(wr), ay = fabsf(wi);
  const float z = __fdividef(fminf(ax, ay), fmaxf(ax, ay));
  const float s = z * z;
  float q = 0.00738483341f;
  q = fmaf(q, s, -0.0355649926f);
  q = fmaf(q, s, 0.0822363347f);
  q = fmaf(q, s, -0.134035528f);
  q = fmaf(q, s, 0.198633403f);
  q = fmaf(q, s, -0.333255589f);
  float r = fmaf(q, z * s, z);
  r = ay > ax ? 1.57079632679489662f - r : r;
  r = wr < 0.f ? 3.14159265358979324f - r : r;
  return wi < 0.f ? -r : r;
}

// One sample: returns kOut of the phase the detector saw (the subcarrier
// -sin 2p = -Re w Im w, or the phase p), and turns (w, f) on by one
// sample. as = ak s_row, bs = ai s_row.
template <int kMode, int kOut>
__device__ __forceinline__ float phasor_sample(float x, float& wr, float& wi,
                                               float& f, float as, float bs,
                                               float cw, float sw, float& m) {
  const float out =
      kOut == kNcoSubcarrier ? __fmul_rn(-wr, wi) : nco_phase(wr, wi);
  const float a = __fmul_rn(as, x);
  const float b = __fmul_rn(bs, x);
  const float psi = __fmaf_rn(a, wr, f);
  f = __fmaf_rn(b, wr, f);
  const float ur = __fmaf_rn(wr, cw, __fmul_rn(-wi, sw));
  const float ui = __fmaf_rn(wr, sw, __fmul_rn(wi, cw));
  if (kMode == kPhasorExact ||
      (kMode == kPhasorEither && fabsf(psi) > kNcoPsiMax)) {
    float c, s;
    sincosf(psi, &s, &c);
    wr = __fmaf_rn(ur, c, __fmul_rn(-ui, s));
    wi = __fmaf_rn(ui, c, __fmul_rn(ur, s));
  } else {
    if (kMode == kPhasorSeries) m = fmaxf(m, fabsf(psi));
    const float h = __fmul_rn(0.5f, psi);
    const float qr = __fmaf_rn(h, ur, ui);
    const float qi = __fmaf_rn(-h, ui, ur);
    wr = __fmaf_rn(-psi, qr, ur);
    wi = __fmaf_rn(psi, qi, ui);
  }
  return out;
}

struct PhasorState {
  float wr, wi, f;
};

// The exact rotation over `count` samples from `st`, the pilot read back
// from `x` and the output written again to `out`: a tile's redo, out of
// line so that the fast path's code stays in one piece.
template <int kOut>
__device__ __noinline__ PhasorState phasor_redo(const float* x, float* out,
                                                int count, PhasorState st,
                                                float as, float bs, float cw,
                                                float sw) {
  float m = 0.0f;
  for (int j = 0; j < count; ++j) {
    out[j] = phasor_sample<kPhasorExact, kOut>(__ldcs(x + j), st.wr, st.wi,
                                               st.f, as, bs, cw, sw, m);
  }
  return st;
}

// Four samples of a tile's output by one 16-byte store (kVec) or by four
// scalar ones.
template <bool kVec>
__device__ __forceinline__ void phasor_store4(float* dst, float a, float b,
                                              float c, float d) {
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(a, b, c, d));
  } else {
    __stcs(dst, a);
    __stcs(dst + 1, b);
    __stcs(dst + 2, c);
    __stcs(dst + 3, d);
  }
}

// |w| back to sqrt(2): one Newton step of 1 / |w|, once a tile.
__device__ __forceinline__ void phasor_renorm(float& wr, float& wi) {
  const float g =
      __fmaf_rn(__fmaf_rn(wr, wr, __fmul_rn(wi, wi)), -0.25f, 1.5f);
  wr = __fmul_rn(wr, g);
  wi = __fmul_rn(wi, g);
}

// kN samples (a multiple of 4) on the series, each four stored as soon as
// they are worked, so that the stores spread over the tile; if one of them
// had |psi| past the series' limit, the tile again from the same state
// with sincosf (phasor_redo, which stores over the first results),
// counted on `redone`. Then |w| back to sqrt(2).
template <bool kVec, int kOut, int kN>
__device__ __forceinline__ void phasor_tile(const float (&x)[kN],
                                            const float* xg, float* dst,
                                            float& wr, float& wi, float& f,
                                            float as, float bs, float cw,
                                            float sw,
                                            unsigned long long* redone) {
  static_assert(kN % 4 == 0, "a tile is whole quads");
  const PhasorState st0{wr, wi, f};
  float m = 0.0f;
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = phasor_sample<kPhasorSeries, kOut>(x[4 * q + j], wr, wi, f, as,
                                                bs, cw, sw, m);
    }
    phasor_store4<kVec>(dst + 4 * q, o[0], o[1], o[2], o[3]);
  }
  if (m > kNcoPsiMax) {
    const PhasorState st =
        phasor_redo<kOut>(xg, dst, kN, st0, as, bs, cw, sw);
    wr = st.wr;
    wi = st.wi;
    f = st.f;
    // Never null from rc_nco_pll. Without the test ptxas schedules the
    // tile otherwise, and the kernel ran 1.6% slower at 24 x 240 000
    // (NVIDIA H100 80GB HBM3, 700 W).
    if (redone != nullptr) atomicAdd(redone, 1ULL);
  }
  phasor_renorm(wr, wi);
}

template <bool kVec, int kOut>
__global__ void __launch_bounds__(kNcoThreads)
    nco_pll_kernel_phasor(const NcoPhasor prm) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= prm.rows) return;
  const float* xr = prm.x + row * prm.x_stride;
  float* sr = prm.out + row * prm.n;
  const float s_row = prm.scale[row];
  const float as = __fmul_rn(prm.ak, s_row);
  const float bs = __fmul_rn(prm.ai, s_row);
  const float cw = prm.cw;
  const float sw = prm.sw;
  float wr, wi;
  sincosf(prm.phase_in[row], &wi, &wr);
  wr = __fmul_rn(wr, 1.41421356237309504880f);
  wi = __fmul_rn(wi, 1.41421356237309504880f);
  float f = prm.freq_in[row];
  const long long tiles = prm.n / kNcoPhasorTile;
  float next[kNcoPhasorTile];
  if (tiles > 0) nco_load_tile<kVec>(xr, next);
  for (long long i = 0; i < tiles; ++i) {
    float cur[kNcoPhasorTile];
#pragma unroll
    for (int j = 0; j < kNcoPhasorTile; ++j) cur[j] = next[j];
    if (i + 1 < tiles) {
      nco_load_tile<kVec>(xr + (i + 1) * kNcoPhasorTile, next);
    }
    if (i + kNcoAhead < tiles) {
      asm volatile("prefetch.global.L2 [%0];"
                   :
                   : "l"(xr + (i + kNcoAhead) * kNcoPhasorTile));
    }
    phasor_tile<kVec, kOut>(
        cur, xr + i * kNcoPhasorTile, sr + i * kNcoPhasorTile, wr, wi, f, as,
        bs, cw, sw, prm.redone);
  }
  float m = 0.0f;
  for (long long t = tiles * kNcoPhasorTile; t < prm.n; ++t) {
    sr[t] = phasor_sample<kPhasorEither, kOut>(xr[t], wr, wi, f, as, bs, cw,
                                               sw, m);
  }
  // The phase's first sample is the phase given (the scan's), not the
  // rounded atan2 of its phasor; the same thread stored it above.
  if (kOut == kNcoPhase) sr[0] = prm.phase_in[row];
  prm.phase_out[row] = atan2f(wi, wr);
  prm.freq_out[row] = f;
}

// The measuring aid behind rc_nco_chain_probe: each thread runs n links of
// a chain with x and the constants in registers, no loads or stores, and
// writes its state and the SM cycles the loop took once at the end.
//   kChain 0: the bare recurrence, w' = (w e^{jw0}) e^{jpsi} with
//             psi = fma(a, Re w, f) and the series, and f's update
//   kChain 1: the kernel's tiles without memory: each sample's subcarrier
//             and the max of |psi| kept (an empty asm, no instruction) in
//             place of the stores and the guard's branch, and |w|'s
//             renormalisation, n / kNcoPhasorTile of them
template <int kChain>
__global__ void nco_chain_probe_kernel(float* result, long long* cycles,
                                       long long n, float x, float kp,
                                       float ki, float w0) {
  const float kk = __fadd_rn(ki, kp);
  float f = 0.0f;
  const long long t0 = clock64();
  const float as = __fmul_rn(kk, 0.70710678118654752440f);
  const float bs = __fmul_rn(ki, 0.70710678118654752440f);
  const float cw = cosf(w0);
  const float sw = sinf(w0);
  float wr, wi;
  sincosf(0.01f * threadIdx.x, &wi, &wr);
  wr = __fmul_rn(wr, 1.41421356237309504880f);
  wi = __fmul_rn(wi, 1.41421356237309504880f);
  if (kChain == 0) {
    float m = 0.0f;
#pragma unroll 16
    for (long long i = 0; i < n; ++i) {
      phasor_sample<kPhasorSeries, kNcoSubcarrier>(x, wr, wi, f, as, bs, cw,
                                                   sw, m);
    }
  } else {
    for (long long i = 0; i < n / kNcoPhasorTile; ++i) {
      float m = 0.0f;
#pragma unroll
      for (int j = 0; j < kNcoPhasorTile; ++j) {
        const float o = phasor_sample<kPhasorSeries, kNcoSubcarrier>(
            x, wr, wi, f, as, bs, cw, sw, m);
        asm volatile("" : : "f"(o));
      }
      asm volatile("" : : "f"(m));
      phasor_renorm(wr, wi);
    }
  }
  const long long t1 = clock64();
  result[threadIdx.x] = (wr + wi) + f;
  cycles[threadIdx.x] = t1 - t0;
}

// The launch: `lanes` rows a block (nco_lanes), `blocks` blocks.
inline cudaError_t nco_grid(long long rows, int* lanes_out,
                            unsigned* blocks_out) {
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  const int lanes = rc::nco_lanes(rows, sms);
  const long long blocks = (rows + lanes - 1) / lanes;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *lanes_out = lanes;
  *blocks_out = (unsigned)blocks;
  return cudaSuccess;
}

template <int kOut>
void nco_launch(const NcoPhasor& p, bool vec, unsigned blocks, int lanes,
                cudaStream_t s) {
  if (vec) {
    nco_pll_kernel_phasor<true, kOut><<<blocks, lanes, 0, s>>>(p);
  } else {
    nco_pll_kernel_phasor<false, kOut><<<blocks, lanes, 0, s>>>(p);
  }
}

}  // namespace rc

// K-NCO over the pilot `x`, each row scaled by `scale` (1 / RMS, or 1);
// `out` takes `output` a sample (kNcoSubcarrier: -sin 2p; kNcoPhase: p).
// ak = (ki + kp) / sqrt(2), ai = ki / sqrt(2) and (cw, sw) = e^{j w0},
// float32 from the host. `redone` (one unsigned 64-bit count on the
// device) is added to once a tile done again with sincosf.
extern "C" int rc_nco_pll(const void* x, long long x_stride,
                          const void* scale, const void* phase_in,
                          const void* freq_in, void* out, void* phase_out,
                          void* freq_out, void* redone, long long rows,
                          long long n, float ak, float ai, float cw, float sw,
                          int output, void* stream) {
  if (rows < 1 || n < 1 ||
      (output != rc::kNcoSubcarrier && output != rc::kNcoPhase)) {
    return (int)cudaErrorInvalidValue;
  }
  int lanes = 0;
  unsigned blocks = 0;
  const cudaError_t e = rc::nco_grid(rows, &lanes, &blocks);
  if (e != cudaSuccess) return (int)e;
  rc::NcoPhasor p;
  p.x = (const float*)x;
  p.x_stride = x_stride;
  p.scale = (const float*)scale;
  p.phase_in = (const float*)phase_in;
  p.freq_in = (const float*)freq_in;
  p.out = (float*)out;
  p.phase_out = (float*)phase_out;
  p.freq_out = (float*)freq_out;
  p.redone = (unsigned long long*)redone;
  p.rows = rows;
  p.n = n;
  p.ak = ak;
  p.ai = ai;
  p.cw = cw;
  p.sw = sw;
  // 16-byte accesses need every row of x and of out on a 16-byte boundary.
  const bool vec = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(out) & 15) == 0) &&
                   (x_stride % 4 == 0) && (n % 4 == 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (output == rc::kNcoSubcarrier) {
    rc::nco_launch<rc::kNcoSubcarrier>(p, vec, blocks, lanes, s);
  } else {
    rc::nco_launch<rc::kNcoPhase>(p, vec, blocks, lanes, s);
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
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
