// Shared core of K-FFT (fft_rows.cu), K-EXTRACT (extract.cu), K-MIXED
// (fft_mixed.cu) and K-XDEMOD (extract_demod.cu): one pass of a multi-pass
// power-of-two FFT over interleaved complex64 (float2), and the in-block
// FFT it is built on.
//
// A pass computes a batch of length-L sub-FFTs (16 <= L <= 4096). Sub-FFT
// (b0, b1, s) reads element j at
//     in  + b0*ib0 + b1*ib1 + s*is + j*ij
// and writes element k at
//     out + b0*ob0 + b1*ob1 + s*os + k*ok,
// optionally multiplied by the four-step twiddle exp(sign*2*pi*i*(s*k)/tw_n).
// The host plan (kernels/fft_rows.py) chains two passes for rows up to
// 4096^2 points and three above that. A block holds P sub-FFTs with
// consecutive s, so a strided load or store still moves runs of P
// neighbouring elements.
//
// What bounds a pass on an H100: device-memory traffic, 16 B per point
// (one read, one write), with strided runs of P points on one or both
// sides. What keeps a pass from that bound is work during which device
// memory idles: shared-memory round trips and barriers between butterfly
// stages, twiddle work, scattered accesses, and an SM with nothing else
// to run while its one block computes.
//
// What this design does about it:
//  - Each thread holds 16 points in registers. A sub-FFT is a Stockham
//    chain of radix-16/8/4 stages (fft_row): the butterflies run in
//    registers and only the ceil(log2(L)/4) - 1 exchanges between stages
//    touch shared memory (two for L = 4096 or 512), in natural order, so
//    there is no bit-reversed scatter. Up to L = 512 a row's threads are
//    one warp's, and the exchanges take a warp barrier: the rows of a
//    block run through their transforms without waiting for each other.
//  - A block is P*L/16 threads and P*(L + L/16 + 1) points of shared
//    memory. The host plan picks P = 8192/L, at least 4 (whole 32-byte
//    sectors on a strided side): below L = 4096 two blocks are resident
//    per SM, and one block's loads overlap another's butterflies. At
//    L = 512 it picks P = 8: three blocks of 256 threads per SM have 80
//    registers a thread where two of 512 have 64 and spill.
//  - On a unit-stride side the thread's own points go straight between
//    registers and device memory (coalesced, no shared-memory staging);
//    on a strided side the block stages through shared memory with s
//    fastest, two neighbouring sub-FFTs per 16-byte access where they are
//    neighbours in memory.
//  - The sub-FFT twiddles come from per-stage tables built once per
//    device in double precision (ensure_tables), laid out so that a warp
//    reads neighbours. The four-step twiddle on the store is sincospif of
//    an exact argument (tw_n is a power of two, the phase reduced mod
//    tw_n on integers first): on the card that beat a two-level table,
//    whose reads scatter across a warp. A thread's twiddles form a
//    geometric sequence, so only every fourth is a sincospif and the rest
//    are products (store_rows). Built without --use_fast_math.
//  - The kernels are built for any L (read from the pass) and with L as
//    a constant: 512 (kFastLg), where fft_row is three radix-8 stages
//    alone and the row geometry folds into the addresses (blocks of up to
//    kFastThreads; a larger block of 512-point rows takes the build for
//    any L), and, for K-FFT's plain passes, 4096 (kBandLg).
//
// Measured on an H100 (PERF.md): a pass is bound by the instructions it
// executes (about half of what an SM can start per cycle), not by device
// memory: with its input in the L2 it takes as long as from device memory.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <vector>

// Each instantiation of fft_pass_kernel lives in one source only (LOAD,
// STORE; each for LG = 0 and kFastLg): fft_rows.cu (0, 0), also for
// kBandLg; extract.cu (1, 1), (1, 0), (0, 1); extract_demod.cu (0, 2).
namespace rc {

constexpr int kMaxSub = 4096;        // longest sub-FFT of one pass
constexpr int kMinSub = 16;          // shortest: one thread's 16 points
constexpr int kBlockPoints = 16384;  // P*L per block at most (1024 threads)
constexpr int kVals = 16;            // points per thread

enum LoadMode { kLoadStrided = 0, kLoadExtract = 1 };
// kStoreKeep: strided store of only the elements s*os + k*ok < keep.
enum StoreMode { kStoreStrided = 0, kStoreFlip = 1, kStoreKeep = 2 };

struct Pass {
  int L, lg;    // sub-FFT length, log2(L)
  int P, lgP;   // sub-FFTs per block (power of two), log2(P)
  long long S;  // sub-FFTs per (b0, b1)
  long long B0, B1;
  long long ib0, ib1, is, ij;
  long long ob0, ob1, os, ok;
  long long tw_n;  // 0: no twiddle on store
  int lgtw;        // log2(tw_n)
  float sign;      // -1 forward, +1 backward
  long long keep;  // kStoreKeep only
};

// K-EXTRACT's load prologue. `off` is the flat index into the (c, m)
// station array, i.e. station*m + k; the station's raw run starts at
// spectrum bin (a0 + station*m) mod n.
struct Extract {
  long long n, m, a0;
  float s_norm;
};

// Stage twiddles, laid out so that a warp's butterflies read neighbours:
// a Stockham stage of radix R = 2^bits and span N = Ns*R (16 <= N <= 4096)
// reads exp(2*pi*i*q*bm/N) at g_stage[stage_offset(log2 N, bits) + q*Ns +
// bm], bm < Ns.
constexpr int kStageEntries = 3 * (kMaxSub * 2 - 16);
static __device__ float2 g_stage[kStageEntries];

__host__ __device__ constexpr int stage_offset(int lgN, int bits) {
  return 3 * ((1 << lgN) - 16) + (bits - 2) * (1 << lgN);
}

// Fills this source's tables on the current device, once; a cudaError_t.
static inline int ensure_tables() {
  static std::mutex mu;
  static bool done[256] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 256) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev]) return 0;
  constexpr double kTwoPi = 6.283185307179586476925286766559;
  std::vector<float2> stage(kStageEntries);
  for (int lgN = 4; lgN <= 12; ++lgN) {
    for (int bits = 2; bits <= 4; ++bits) {
      const int N = 1 << lgN, R = 1 << bits, Ns = N / R;
      for (int q = 0; q < R; ++q) {
        for (int bm = 0; bm < Ns; ++bm) {
          const double ph = kTwoPi * (double)(q * bm) / (double)N;
          stage[stage_offset(lgN, bits) + q * Ns + bm] =
              make_float2((float)std::cos(ph), (float)std::sin(ph));
        }
      }
    }
  }
  err = cudaMemcpyToSymbol(g_stage, stage.data(),
                           sizeof(float2) * kStageEntries);
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
  return 0;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// The table entry w with its sign: exp(sign*2*pi*i*phase).
__device__ __forceinline__ float2 signed_tw(const float2* w, float sign) {
  const float2 v = __ldg(w);
  return make_float2(v.x, sign * v.y);
}

// exp(sign*2*pi*i*r/2^lgn), 0 <= r < 2^lgn, lgn <= 30: the four-step
// twiddle. For lgn <= 24 the argument r*2^(1-lgn) is exact in float32 (the
// scale is built from its exponent bits, no division), so the phase error
// is sincospif's alone (about one ulp). On the card this beat a two-level
// table, whose reads scatter across a warp (PERF.md).
__device__ __forceinline__ float2 tw_four(long long r, int lgn, float sign) {
  float sn, cs;
  sincospif((float)(int)r * __int_as_float((128 - lgn) << 23), &sn, &cs);
  return make_float2(cs, sign * sn);
}

// d * exp(sign*2*pi*i*e/16), 0 <= e < 8; e is a constant after unrolling,
// so the branches fold away.
__device__ __forceinline__ float2 rot16(float2 d, int e, float sign) {
  if (e == 0) return d;
  if (e == 4) return make_float2(-sign * d.y, sign * d.x);
  const float c1 = 0.923879532511286756f, c2 = 0.707106781186547524f,
              c3 = 0.382683432365089772f;
  const float c = e == 1 ? c1 : e == 2 ? c2 : e == 3 ? c3
                : e == 5 ? -c3 : e == 6 ? -c2 : -c1;
  const float s = e == 1 ? c3 : e == 2 ? c2 : e == 3 ? c1
                : e == 5 ? c1 : e == 6 ? c2 : c3;
  const float ss = sign * s;
  return make_float2(d.x * c - d.y * ss, d.x * ss + d.y * c);
}

__host__ __device__ constexpr int brev(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

__host__ __device__ constexpr int ilog2(int r) {
  int b = 0;
  while ((1 << b) < r) ++b;
  return b;
}

// One radix-2 decimation-in-frequency level of an in-register R-point DFT
// (pairs H apart), then the next; template recursion keeps every register
// index a compile-time constant.
template <int R, int H>
struct Dif {
  static __device__ __forceinline__ void run(float2 (&u)[R], float sign) {
#pragma unroll
    for (int blk = 0; blk < R; blk += 2 * H) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float2 a = u[blk + i], b = u[blk + i + H];
        u[blk + i] = cadd(a, b);
        u[blk + i + H] = rot16(csub(a, b), i * (8 / H), sign);
      }
    }
    Dif<R, H / 2>::run(u, sign);
  }
};

template <int R>
struct Dif<R, 0> {
  static __device__ __forceinline__ void run(float2 (&)[R], float) {}
};

// t[K..R) = u[bit-reversed K..R).
template <int R, int K>
struct Unscramble {
  static __device__ __forceinline__ void run(const float2 (&u)[R],
                                             float2 (&t)[R]) {
    constexpr int kFrom = brev(K, ilog2(R));
    t[K] = u[kFrom];
    Unscramble<R, K + 1>::run(u, t);
  }
};

template <int R>
struct Unscramble<R, R> {
  static __device__ __forceinline__ void run(const float2 (&)[R],
                                             float2 (&)[R]) {}
};

// In-register R-point DFT (R = 2, 4, 8, 16), natural order in and out:
// radix-2 decimation in frequency, then a register renaming.
template <int R>
__device__ __forceinline__ void dft(float2 (&u)[R], float sign) {
  Dif<R, R / 2>::run(u, sign);
  float2 t[R];
  Unscramble<R, 0>::run(u, t);
#pragma unroll
  for (int k = 0; k < R; ++k) u[k] = t[k];
}

// Shared-memory position of element e of a row (one pad slot per 16).
__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }

// Points of shared memory one row of L takes; odd, so that rows at the
// same element fall in different banks.
__host__ __device__ constexpr int row_pitch(int L) { return L + (L >> 4) + 1; }

// Stages of an L = 2^lg point sub-FFT: ceil(lg/4) stages, the larger
// radices first (lg = 12: 16,16,16; lg = 9: 8,8,8; lg = 10: 16,8,8).
// kernels/fft_rows.py stage_bits() mirrors this.
__device__ __forceinline__ int stage_bits(int lg, int st) {
  const int nst = (lg + 3) >> 2;
  return lg / nst + (st < lg % nst ? 1 : 0);
}

// Stockham radix-R stage of the sub-FFT. Thread t of the row's T = L/16
// holds the stage's inputs at positions t + m*T (m < 16) in v[m];
// butterfly b = t + i*T (i < 16/R) takes positions b + q*L/R, i.e.
// v[i + q*16/R], twiddles them by W_{Ns*R}^(q*(b mod Ns)) and leaves its
// outputs in the same slots. Output q of butterfly b belongs at position
// (b - b mod Ns)*R + b mod Ns + q*Ns.
template <int R>
__device__ __forceinline__ void radix_stage(float2 (&v)[kVals], int t, int T,
                                            int Ns, float sign) {
  constexpr int G = kVals / R;
  constexpr int kBits = ilog2(R);
  const float2* tab = g_stage + stage_offset(__ffs(Ns) - 1 + kBits, kBits);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int bm = (t + i * T) & (Ns - 1);
    float2 u[R];
#pragma unroll
    for (int q = 0; q < R; ++q) u[q] = v[i + q * G];
    if (Ns > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) {
        u[q] = cmul(u[q], signed_tw(tab + q * Ns + bm, sign));
      }
    }
    dft<R>(u, sign);
#pragma unroll
    for (int q = 0; q < R; ++q) v[i + q * G] = u[q];
  }
}

// Barrier among the T = L/16 threads of a row. Up to L = 512 a row's
// threads lie in one warp (thread = row*T + t, T divides 32), so a warp
// barrier does, and the rows of a block run through their transforms
// without waiting for each other; longer rows take the block's barrier
// (T is the same for every thread of the block).
__device__ __forceinline__ void row_sync(int T) {
  if (T <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Writes a stage's outputs to their positions in `row` and reads the next
// stage's inputs (positions t + m*T) back.
template <int R>
__device__ __forceinline__ void exchange(float2 (&v)[kVals], float2* row,
                                         int t, int T, int Ns) {
  constexpr int G = kVals / R;
  row_sync(T);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int b = t + i * T;
    const int bm = b & (Ns - 1);
    const int base = (b - bm) * R + bm;
#pragma unroll
    for (int q = 0; q < R; ++q) row[pad(base + q * Ns)] = v[i + q * G];
  }
  row_sync(T);
#pragma unroll
  for (int m = 0; m < kVals; ++m) v[m] = row[pad(t + m * T)];
}

// Unnormalized DFT of one row of L = 2^lg points (16 <= L <= 4096), spread
// over the row's L/16 threads: thread t holds x[t + m*L/16] in v[m] on
// entry and X[t + m*L/16] on exit. `row` is the row's shared-memory
// scratch (row_pitch(L) points), which only the row's own threads touch
// inside. Every thread of the block calls it with the same lg (it holds
// row_sync barriers); it begins and ends without one.
__device__ __forceinline__ void fft_row(float2 (&v)[kVals], float2* row,
                                        int t, int lg, float sign) {
  const int T = 1 << (lg - 4);
  const int nst = (lg + 3) >> 2;
  int Ns = 1;
  for (int st = 0; st < nst; ++st) {
    const int bits = stage_bits(lg, st);
    const bool more = st + 1 < nst;
    if (bits == 4) {
      radix_stage<16>(v, t, T, Ns, sign);
      if (more) exchange<16>(v, row, t, T, Ns);
    } else if (bits == 3) {
      radix_stage<8>(v, t, T, Ns, sign);
      if (more) exchange<8>(v, row, t, T, Ns);
    } else {
      radix_stage<4>(v, t, T, Ns, sign);
      if (more) exchange<4>(v, row, t, T, Ns);
    }
    Ns <<= bits;
  }
}

// Accesses of data that is touched exactly once (the spectrum read of the
// extraction load, the result stores kStoreFlip and kStoreKeep, the quad
// store): evict-first (ld/st.global.cs), so that they do not push the
// station-group scratch, which is written and read back, out of the L2.
template <typename T>
__device__ __forceinline__ T ld_once(const T* p) { return __ldcs(p); }
template <typename T>
__device__ __forceinline__ void st_once(T* p, T v) { __stcs(p, v); }

// A pass's store: scratch and K-FFT results are default stores; the flip
// and keep stores write a result that this kernel never reads again.
template <int STORE, typename T>
__device__ __forceinline__ void st_pass(T* p, T v) {
  if (STORE == kStoreStrided) {
    *p = v;
  } else {
    st_once(p, v);
  }
}

// The window's phase step per bin in units of pi, 2/n: one division per
// thread, the per-element phase a multiplication (exact for n a power of
// two, within one rounding of the quotient otherwise).
__device__ __forceinline__ float window_step(const Extract& e) {
  return 2.0f / (float)e.n;
}

// The bin m after `at` (< n), mod n: m <= n, so one conditional
// subtraction (a 64-bit % is a subroutine call in the middle of the loads).
__device__ __forceinline__ long long next_run(long long at, const Extract& e) {
  const long long nx = at + e.m;
  return nx >= e.n ? nx - e.n : nx;
}

// Closed-form hann window (times s_norm) at raw coordinate k, plus the
// Nyquist fold u[0] = (x[0] + next station's x[0]) * w[0]. off < c*m <= n
// and a0 < n, so one conditional subtraction reduces a0 + off mod n;
// m <= 2^19, so k is a 32-bit integer. (A table of the m weights in place
// of the cosine measured 1.5% faster on an H100: not worth its buffer.)
__device__ __forceinline__ float2 extract_load(const float2* __restrict__ spec,
                                               long long off,
                                               const Extract& e) {
  const int k = (int)(off & (e.m - 1));
  const float w = 0.5f * e.s_norm *
                  (1.0f + cospif((float)(k - (int)(e.m / 2)) * window_step(e)));
  long long at = e.a0 + off;
  if (at >= e.n) at -= e.n;
  float2 x = ld_once(spec + at);
  if (k == 0) {
    const float2 nx = ld_once(spec + next_run(at, e));
    x.x += nx.x;
    x.y += nx.y;
  }
  return make_float2(x.x * w, x.y * w);
}

// extract_load of the neighbours off and off + 1 in one 16-byte access.
// For even a0 + off (m and n are even, so both lie in one station's run
// and neither side of the wrap at n separates them) and a 16-byte aligned
// spectrum.
__device__ __forceinline__ float4 extract_load2(
    const float2* __restrict__ spec, long long off, const Extract& e) {
  const int k = (int)(off & (e.m - 1));
  const float half = 0.5f * e.s_norm;
  const int c = k - (int)(e.m / 2);
  const float2 w =
      make_float2(half * (1.0f + cospif((float)c * window_step(e))),
                  half * (1.0f + cospif((float)(c + 1) * window_step(e))));
  long long at = e.a0 + off;
  if (at >= e.n) at -= e.n;
  float4 x = ld_once(reinterpret_cast<const float4*>(spec + at));
  if (k == 0) {
    const float2 nx = ld_once(spec + next_run(at, e));
    x.x += nx.x;
    x.y += nx.y;
  }
  return make_float4(x.x * w.x, x.y * w.x, x.z * w.y, x.w * w.y);
}

template <int LOAD>
__device__ __forceinline__ float2 load_one(const float2* __restrict__ in,
                                           long long off, const Extract& e) {
  if (LOAD == kLoadStrided) return in[off];
  return extract_load(in, off, e);
}

template <int LOAD>
__device__ __forceinline__ float4 load_two(const float2* __restrict__ in,
                                           long long off, const Extract& e) {
  if (LOAD == kLoadStrided) return *reinterpret_cast<const float4*>(in + off);
  return extract_load2(in, off, e);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The store epilogue of element k of sub-FFT s at `off`: the four-step
// twiddle, or the (-1)^t roll flip (m is even, so t = off mod m has off's
// parity).
template <int STORE>
__device__ __forceinline__ float2 finish(float2 v, long long s, int k,
                                         long long off, const Pass& d) {
  if (STORE != kStoreFlip) {
    if (d.tw_n) v = cmul(v, tw_four((s * k) & (d.tw_n - 1), d.lgtw, d.sign));
  } else if (off & 1) {
    v = make_float2(-v.x, -v.y);
  }
  return v;
}

// Strided-side load of the block's P rows into shared memory, s fastest.
// The block is P*L/16 threads, so each thread moves exactly 16 points, in
// groups of kLoadGroup loads issued before their shared-memory writes
// (more in flight per thread; a larger group spills under the 64-register
// bound of 1024-thread blocks). Where is == 1 and every pair is whole and
// 16-byte aligned, two neighbouring sub-FFTs come in one float4 (for the
// extraction load: where the start bin a0 is even).
constexpr int kLoadGroup = 4;

template <int LOAD>
__device__ __forceinline__ void load_rows(const float2* __restrict__ in,
                                          float2* smem, int pitch,
                                          long long s0, long long in_base,
                                          const Pass& d, const Extract& e) {
  const int P = d.P;
  const bool pairs =
      d.is == 1 && P >= 2 && (d.S & (P - 1)) == 0 && (d.ij & 1) == 0 &&
      (LOAD == kLoadStrided
           ? aligned16(in + in_base)
           : aligned16(in) && ((e.a0 | in_base) & 1) == 0);
  if (pairs) {
#pragma unroll
    for (int g = 0; g < kVals / 2; g += kLoadGroup) {
      float4 w[kLoadGroup];
#pragma unroll
      for (int it = 0; it < kLoadGroup; ++it) {
        const int idx = threadIdx.x + (g + it) * blockDim.x;
        const int p = (idx & ((P >> 1) - 1)) << 1;
        const int j = idx >> (d.lgP - 1);
        w[it] = load_two<LOAD>(in, in_base + s0 + p + (long long)j * d.ij, e);
      }
#pragma unroll
      for (int it = 0; it < kLoadGroup; ++it) {
        const int idx = threadIdx.x + (g + it) * blockDim.x;
        const int p = (idx & ((P >> 1) - 1)) << 1;
        const int j = idx >> (d.lgP - 1);
        smem[p * pitch + pad(j)] = make_float2(w[it].x, w[it].y);
        smem[(p + 1) * pitch + pad(j)] = make_float2(w[it].z, w[it].w);
      }
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < kVals; g += kLoadGroup) {
    float2 v[kLoadGroup];
#pragma unroll
    for (int it = 0; it < kLoadGroup; ++it) {
      const int idx = threadIdx.x + (g + it) * blockDim.x;
      const long long s = s0 + (idx & (P - 1));
      const long long j = idx >> d.lgP;
      v[it] = (s < d.S) ? load_one<LOAD>(in, in_base + s * d.is + j * d.ij, e)
                        : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < kLoadGroup; ++it) {
      const int idx = threadIdx.x + (g + it) * blockDim.x;
      smem[(idx & (P - 1)) * pitch + pad(idx >> d.lgP)] = v[it];
    }
  }
}

// Terms of a twiddle sequence between two exact ones (store_rows).
constexpr int kTwRun = 4;

// Strided-side store of the block's P rows from shared memory, s
// fastest, 16 points per thread; two neighbouring sub-FFTs per 16-byte
// store where os == 1 and every pair is whole and aligned.
template <int STORE>
__device__ __forceinline__ void store_rows(float2* __restrict__ out,
                                           const float2* smem, int pitch,
                                           long long s0, long long out_base,
                                           const Pass& d) {
  const int P = d.P;
  const bool pairs = d.os == 1 && P >= 2 && (d.S & (P - 1)) == 0 &&
                     (d.ok & 1) == 0 && aligned16(out + out_base);
  if (pairs && STORE == kStoreStrided && d.tw_n) {
    // The four-step twiddle of a thread's elements: its rows s, s + 1 are
    // the same in every iteration (the block is a multiple of P threads)
    // and k advances by dk, so W^(s*k) is a geometric sequence. Every
    // kTwRun-th term is sincospif of the exact phase and the ones between
    // follow by multiplication with W^(s*dk): a third of the sincospif
    // calls, at most kTwRun - 1 roundings more.
    const int p = (threadIdx.x & ((P >> 1) - 1)) << 1;
    const int k0 = threadIdx.x >> (d.lgP - 1);
    const int dk = blockDim.x >> (d.lgP - 1);
    const long long s = s0 + p;
    const long long mask = d.tw_n - 1;
    const float2 ra = tw_four((s * dk) & mask, d.lgtw, d.sign);
    const float2 rb = tw_four(((s + 1) * dk) & mask, d.lgtw, d.sign);
    float2 wa = ra, wb = rb;
#pragma unroll
    for (int it = 0; it < kVals / 2; ++it) {
      const int k = k0 + it * dk;
      if (it % kTwRun == 0) {
        wa = tw_four((s * k) & mask, d.lgtw, d.sign);
        wb = tw_four(((s + 1) * k) & mask, d.lgtw, d.sign);
      }
      const float2 a = cmul(smem[p * pitch + pad(k)], wa);
      const float2 b = cmul(smem[(p + 1) * pitch + pad(k)], wb);
      *reinterpret_cast<float4*>(out + out_base + s + (long long)k * d.ok) =
          make_float4(a.x, a.y, b.x, b.y);
      wa = cmul(wa, ra);
      wb = cmul(wb, rb);
    }
    return;
  }
  if (pairs) {
#pragma unroll
    for (int it = 0; it < kVals / 2; ++it) {
      const int idx = threadIdx.x + it * blockDim.x;
      const int p = (idx & ((P >> 1) - 1)) << 1;
      const int k = idx >> (d.lgP - 1);
      const long long s = s0 + p;
      const long long rel = s + (long long)k * d.ok;
      if (STORE == kStoreKeep && rel >= d.keep) continue;
      const long long off = out_base + rel;
      const float2 a = finish<STORE>(smem[p * pitch + pad(k)], s, k, off, d);
      if (STORE == kStoreKeep && rel + 1 >= d.keep) {
        st_pass<STORE>(out + off, a);
        continue;
      }
      const float2 b =
          finish<STORE>(smem[(p + 1) * pitch + pad(k)], s + 1, k, off + 1, d);
      st_pass<STORE>(reinterpret_cast<float4*>(out + off),
                     make_float4(a.x, a.y, b.x, b.y));
    }
    return;
  }
#pragma unroll
  for (int it = 0; it < kVals; ++it) {
    const int idx = threadIdx.x + it * blockDim.x;
    const int p = idx & (P - 1);
    const int k = idx >> d.lgP;
    const long long s = s0 + p;
    if (s >= d.S) continue;
    const long long rel = s * d.os + (long long)k * d.ok;
    if (STORE == kStoreKeep && rel >= d.keep) continue;
    const long long off = out_base + rel;
    st_pass<STORE>(out + off,
                   finish<STORE>(smem[p * pitch + pad(k)], s, k, off, d));
  }
}

// The sub-FFT length the kernels are also built for as a constant: 512,
// both halves of a 2^18-point station. With lg known, fft_row is its three
// radix-8 stages alone (no radix-16 path to hold registers for, no loop
// over stages) and the row geometry folds into the addresses.
constexpr int kFastLg = 9;
// That build's block: at most 256 threads (P = 8 rows), three blocks per SM.
constexpr int kFastThreads = 256;
constexpr int kFastBlocks = 3;
// K-FFT's plain passes are also built for L = 4096, the 2^24 band's
// sub-FFT (three radix-16 stages).
constexpr int kBandLg = 12;

// One pass: block = P sub-FFTs of L points, thread (p, t) = row p's
// points t + m*L/16. LG is log2(L) as a constant, or 0: read it from the
// pass.
template <int LOAD, int STORE, int LG>
__global__ void __launch_bounds__(LG == kFastLg ? kFastThreads : 1024,
                                  LG == kFastLg ? kFastBlocks : 1)
    fft_pass_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                    Pass d, Extract e) {
  extern __shared__ float2 smem[];
  const int lg = LG ? LG : d.lg;
  const int T = 1 << (lg - 4);
  const int pitch = row_pitch(1 << lg);
  const int p = threadIdx.x >> (lg - 4);
  const int t = threadIdx.x & (T - 1);
  float2* row = smem + p * pitch;

  // The grid has fewer than 2^31 blocks (make_pass) and P is a power of
  // two: 32-bit divisions and a shift, where 64-bit ones are subroutines
  // that every thread would run.
  const unsigned nsb = (unsigned)((d.S + d.P - 1) >> d.lgP);
  unsigned g = blockIdx.x;
  const long long s0 = (long long)(g % nsb) << d.lgP;
  g /= nsb;
  const long long b1 = g % (unsigned)d.B1;
  const long long b0 = g / (unsigned)d.B1;
  const long long in_base = b0 * d.ib0 + b1 * d.ib1;
  const long long out_base = b0 * d.ob0 + b1 * d.ob1;
  const long long s = s0 + p;

  float2 v[kVals];
  if (d.ij == 1) {
    // Unit stride: each thread loads its own points, a warp reads
    // neighbours.
#pragma unroll
    for (int m = 0; m < kVals; ++m) {
      v[m] = (s < d.S) ? load_one<LOAD>(in, in_base + s * d.is + t + m * T, e)
                       : make_float2(0.f, 0.f);
    }
  } else {
    load_rows<LOAD>(in, smem, pitch, s0, in_base, d, e);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kVals; ++m) v[m] = row[pad(t + m * T)];
  }

  fft_row(v, row, t, lg, d.sign);

  if (d.ok == 1) {
    if (s >= d.S) return;
#pragma unroll
    for (int m = 0; m < kVals; ++m) {
      const int k = t + m * T;
      const long long rel = s * d.os + k;
      if (STORE == kStoreKeep && rel >= d.keep) continue;
      const long long off = out_base + rel;
      st_pass<STORE>(out + off, finish<STORE>(v[m], s, k, off, d));
    }
    return;
  }
  row_sync(T);
#pragma unroll
  for (int m = 0; m < kVals; ++m) row[pad(t + m * T)] = v[m];
  __syncthreads();
  store_rows<STORE>(out, smem, pitch, s0, out_base, d);
}

inline int log2_exact(long long v) {
  int r = 0;
  while ((1LL << r) < v) ++r;
  return ((1LL << r) == v) ? r : -1;
}

// Fills and validates one pass; returns a cudaError_t.
inline int make_pass(Pass* out, int L, int P, long long S, long long B0,
                     long long B1, long long ib0, long long ib1, long long is,
                     long long ij, long long ob0, long long ob1, long long os,
                     long long ok, long long tw_n, int sign, int store,
                     long long keep) {
  Pass d;
  d.L = L;
  d.lg = log2_exact(L);
  d.P = P;
  d.lgP = log2_exact(P);
  d.S = S;
  d.B0 = B0;
  d.B1 = B1;
  d.ib0 = ib0;
  d.ib1 = ib1;
  d.is = is;
  d.ij = ij;
  d.ob0 = ob0;
  d.ob1 = ob1;
  d.os = os;
  d.ok = ok;
  d.tw_n = tw_n;
  d.lgtw = tw_n ? log2_exact(tw_n) : 0;
  d.sign = sign < 0 ? -1.0f : 1.0f;
  d.keep = keep;
  if (L < kMinSub || L > kMaxSub || d.lg < 0 || d.lgP < 0 ||
      (long long)P * L > kBlockPoints || S < 1 || B0 < 1 || B1 < 1 ||
      d.lgtw < 0 || d.lgtw > 30 || (store == kStoreKeep && keep < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B0 * B1 * ((S + P - 1) / P) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  *out = d;
  return 0;
}

inline size_t pass_smem(const Pass& d) {
  return sizeof(float2) * (size_t)d.P * row_pitch(d.L);
}

// What a launch needs besides its arguments: this source's tables on the
// device and the kernel's dynamic shared-memory limit. Static, as are the
// templates below that reach it: g_stage and ensure_tables are per source,
// and a template with external linkage is merged across sources at link
// time, so one source's copy would fill another's tables.
template <typename Kernel>
static int prepare_kernel(Kernel kernel, size_t smem) {
  const int err = ensure_tables();
  if (err) return err;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches `kernel` on `stream`. Returns a cudaError_t.
template <typename... Params, typename... Args>
static int enqueue(void (*kernel)(Params...), long long blocks, int threads,
                   size_t smem, cudaStream_t stream, Args... args) {
  kernel<<<(unsigned)blocks, (unsigned)threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

inline int pass_threads(const Pass& d) { return d.P * d.L / kVals; }

// Whether the pass runs the build for L = 512.
inline bool fast_pass(const Pass& d) {
  return d.lg == kFastLg && pass_threads(d) <= kFastThreads;
}

template <int LOAD, int STORE>
static int prepare_pass(const Pass& d) {
  if (fast_pass(d)) {
    return prepare_kernel(fft_pass_kernel<LOAD, STORE, kFastLg>,
                          pass_smem(d));
  }
  if constexpr (LOAD == kLoadStrided && STORE == kStoreStrided) {
    if (d.lg == kBandLg) {
      return prepare_kernel(fft_pass_kernel<LOAD, STORE, kBandLg>,
                            pass_smem(d));
    }
  }
  return prepare_kernel(fft_pass_kernel<LOAD, STORE, 0>, pass_smem(d));
}

template <int LOAD, int STORE>
static int enqueue_pass(const float2* in, float2* out, const Pass& d,
                        const Extract& e, cudaStream_t stream) {
  const long long blocks = d.B0 * d.B1 * ((d.S + d.P - 1) / d.P);
  const int threads = pass_threads(d);
  if (fast_pass(d)) {
    return enqueue(fft_pass_kernel<LOAD, STORE, kFastLg>, blocks, threads,
                   pass_smem(d), stream, in, out, d, e);
  }
  if constexpr (LOAD == kLoadStrided && STORE == kStoreStrided) {
    if (d.lg == kBandLg) {
      return enqueue(fft_pass_kernel<LOAD, STORE, kBandLg>, blocks, threads,
                     pass_smem(d), stream, in, out, d, e);
    }
  }
  return enqueue(fft_pass_kernel<LOAD, STORE, 0>, blocks, threads,
                 pass_smem(d), stream, in, out, d, e);
}

// A pass as the flat record the host plan hands over (kernels/fft_rows.py
// pass_record): kPassFields long longs.
constexpr int kPassFields = 15;

inline int pass_from_record(Pass* d, const long long* r, int sign,
                            int store) {
  return make_pass(d, (int)r[0], (int)r[1], r[2], r[3], r[4], r[5], r[6],
                   r[7], r[8], r[9], r[10], r[11], r[12], r[13], sign, store,
                   r[14]);
}

// K-EXTRACT's first pass (extraction load, strided store), whose kernel
// lives in extract.cu; K-XDEMOD's schedule in extract_demod.cu enqueues it.
int prepare_extract_first(const Pass& d);
int enqueue_extract_first(const float2* spec, float2* out, const Pass& d,
                          const Extract& e, cudaStream_t stream);

// Lanes of a grouped schedule: station group i runs on lane i mod lanes,
// each lane a stream with a scratch set of its own, so that kernels of
// neighbouring groups overlap. Lane 0 is the caller's stream; the others
// are side streams kept per device (extract.cu). fork makes the side
// streams wait for what the caller's stream has enqueued so far, and join
// makes the caller's stream wait for everything enqueued on them, so the
// whole schedule is ordered on the caller's stream like one kernel. Both
// return a cudaError_t; join is called after a failed launch too. A Lanes object holds a lock on the
// side streams: one schedule at a time enqueues on them.
constexpr int kMaxLanes = 4;

struct Lanes {
  explicit Lanes(int count);
  ~Lanes();
  Lanes(const Lanes&) = delete;
  Lanes& operator=(const Lanes&) = delete;
  int fork(cudaStream_t caller);
  int join();
  cudaStream_t stream(int lane) const { return streams_[lane]; }

 private:
  int count_;
  cudaStream_t streams_[kMaxLanes];
  cudaEvent_t fork_, joins_[kMaxLanes];
};

}  // namespace rc
