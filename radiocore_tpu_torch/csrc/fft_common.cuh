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
//    there is no bit-reversed scatter.
//  - A block is P*L/16 threads and P*(L + L/16 + 1) points of shared
//    memory. The host plan picks P = 8192/L, at least 4 (whole 32-byte
//    sectors on a strided side): below L = 4096 two blocks are resident
//    per SM, and one block's loads overlap another's butterflies.
//  - On a unit-stride side the thread's own points go straight between
//    registers and device memory (coalesced, no shared-memory staging);
//    on a strided side the block stages through shared memory with s
//    fastest, two neighbouring sub-FFTs per 16-byte access where they are
//    neighbours in memory.
//  - The sub-FFT twiddles come from per-stage tables built once per
//    device in double precision (ensure_tables), laid out so that a warp
//    reads neighbouring entries. The four-step twiddle on the store is
//    sincospif of an exact argument (tw_n is a power of two, the phase
//    reduced mod tw_n on integers first): on the card that beat a
//    two-level table, whose reads scatter across a warp. Built without
//    --use_fast_math.
//
// Measured on an H100 (PERF.md): a pass moves its 16 B per point at
// 0.44-0.84 of a plain device copy's rate; the strided sides are what
// is left (32-byte runs at L = 4096, where one 139 KB block fills an SM).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <mutex>
#include <vector>

// Each instantiation of fft_pass_kernel lives in one source only (LOAD,
// STORE): fft_rows.cu (0, 0), extract.cu (1, 1), (1, 0), (0, 1),
// extract_demod.cu (0, 2).
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
  long long B1;
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

// exp(sign*2*pi*i*r/2^lgn), 0 <= r < 2^lgn: the four-step twiddle. For
// lgn <= 24 the argument 2r/2^lgn is exact in float32, so the phase error
// is sincospif's alone (about one ulp). On the card this beat a two-level
// table, whose reads scatter across a warp (PERF.md).
__device__ __forceinline__ float2 tw_four(long long r, int lgn, float sign) {
  float sn, cs;
  sincospif(2.0f * (float)r / (float)(1LL << lgn), &sn, &cs);
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

// Writes a stage's outputs to their positions in `row` and reads the next
// stage's inputs (positions t + m*T) back.
template <int R>
__device__ __forceinline__ void exchange(float2 (&v)[kVals], float2* row,
                                         int t, int T, int Ns) {
  constexpr int G = kVals / R;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int b = t + i * T;
    const int bm = b & (Ns - 1);
    const int base = (b - bm) * R + bm;
#pragma unroll
    for (int q = 0; q < R; ++q) row[pad(base + q * Ns)] = v[i + q * G];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kVals; ++m) v[m] = row[pad(t + m * T)];
}

// Unnormalized DFT of one row of L = 2^lg points (16 <= L <= 4096), spread
// over the row's L/16 threads: thread t holds x[t + m*L/16] in v[m] on
// entry and X[t + m*L/16] on exit. `row` is the row's shared-memory
// scratch (row_pitch(L) points). Every thread of the block calls it with
// the same lg (it holds __syncthreads); it begins and ends without one.
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

// Closed-form hann window (times s_norm) at raw coordinate k, plus the
// Nyquist fold u[0] = (x[0] + next station's x[0]) * w[0]. off < c*m <= n
// and a0 < n, so one conditional subtraction reduces a0 + off mod n.
__device__ __forceinline__ float2 extract_load(const float2* __restrict__ spec,
                                               long long off,
                                               const Extract& e) {
  const long long k = off & (e.m - 1);
  const float w = 0.5f * e.s_norm *
                  (1.0f + cospif(2.0f * (float)(k - e.m / 2) / (float)e.n));
  long long at = e.a0 + off;
  if (at >= e.n) at -= e.n;
  float2 x = spec[at];
  if (k == 0) {
    const float2 nx = spec[(e.a0 + off + e.m) % e.n];
    x.x += nx.x;
    x.y += nx.y;
  }
  return make_float2(x.x * w, x.y * w);
}

template <int LOAD>
__device__ __forceinline__ float2 load_one(const float2* __restrict__ in,
                                           long long off, const Extract& e) {
  if (LOAD == kLoadStrided) return in[off];
  return extract_load(in, off, e);
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
// 16-byte aligned, two neighbouring sub-FFTs come in one float4.
constexpr int kLoadGroup = 4;

template <int LOAD>
__device__ __forceinline__ void load_rows(const float2* __restrict__ in,
                                          float2* smem, int pitch,
                                          long long s0, long long in_base,
                                          const Pass& d, const Extract& e) {
  const int P = d.P;
  const bool pairs = LOAD == kLoadStrided && d.is == 1 && P >= 2 &&
                     d.S % P == 0 && (d.ij & 1) == 0 && aligned16(in + in_base);
  if (pairs) {
#pragma unroll
    for (int g = 0; g < kVals / 2; g += kLoadGroup) {
      float4 w[kLoadGroup];
#pragma unroll
      for (int it = 0; it < kLoadGroup; ++it) {
        const int idx = threadIdx.x + (g + it) * blockDim.x;
        const int p = (idx & ((P >> 1) - 1)) << 1;
        const int j = idx >> (d.lgP - 1);
        w[it] = *reinterpret_cast<const float4*>(in + in_base + s0 + p +
                                                 (long long)j * d.ij);
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

// Strided-side store of the block's P rows from shared memory, s
// fastest, 16 points per thread; two neighbouring sub-FFTs per 16-byte
// store where os == 1 and every pair is whole and aligned.
template <int STORE>
__device__ __forceinline__ void store_rows(float2* __restrict__ out,
                                           const float2* smem, int pitch,
                                           long long s0, long long out_base,
                                           const Pass& d) {
  const int P = d.P;
  const bool pairs = d.os == 1 && P >= 2 && d.S % P == 0 &&
                     (d.ok & 1) == 0 && aligned16(out + out_base);
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
        out[off] = a;
        continue;
      }
      const float2 b =
          finish<STORE>(smem[(p + 1) * pitch + pad(k)], s + 1, k, off + 1, d);
      *reinterpret_cast<float4*>(out + off) = make_float4(a.x, a.y, b.x, b.y);
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
    out[off] = finish<STORE>(smem[p * pitch + pad(k)], s, k, off, d);
  }
}

// One pass: block = P sub-FFTs of L points, thread (p, t) = row p's
// points t + m*L/16.
template <int LOAD, int STORE>
__global__ void __launch_bounds__(1024)
    fft_pass_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                    Pass d, Extract e) {
  extern __shared__ float2 smem[];
  const int lg = d.lg;
  const int T = 1 << (lg - 4);
  const int pitch = row_pitch(d.L);
  const int p = threadIdx.x >> (lg - 4);
  const int t = threadIdx.x & (T - 1);
  float2* row = smem + p * pitch;

  const long long nsb = (d.S + d.P - 1) / d.P;
  long long g = blockIdx.x;
  const long long s0 = (g % nsb) * d.P;
  g /= nsb;
  const long long b1 = g % d.B1;
  const long long b0 = g / d.B1;
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
      out[off] = finish<STORE>(v[m], s, k, off, d);
    }
    return;
  }
  __syncthreads();
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

// Validates one pass and launches it on `stream`; returns a cudaError_t.
template <int LOAD, int STORE>
int launch_pass(const void* in, void* out, int L, int P, long long S,
                long long B0, long long B1, long long ib0, long long ib1,
                long long is, long long ij, long long ob0, long long ob1,
                long long os, long long ok, long long tw_n, int sign,
                const Extract& e, cudaStream_t stream, long long keep = 0) {
  Pass d;
  d.L = L;
  d.lg = log2_exact(L);
  d.P = P;
  d.lgP = log2_exact(P);
  d.S = S;
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
      d.lgtw < 0 || d.lgtw > 62 || (STORE == kStoreKeep && keep < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = B0 * B1 * ((S + P - 1) / P);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int err = ensure_tables();
  if (err) return err;
  const size_t smem = sizeof(float2) * (size_t)P * row_pitch(L);
  err = (int)cudaFuncSetAttribute(fft_pass_kernel<LOAD, STORE>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const int threads = P * L / kVals;
  fft_pass_kernel<LOAD, STORE><<<(unsigned)blocks, threads, smem, stream>>>(
      (const float2*)in, (float2*)out, d, e);
  return (int)cudaGetLastError();
}

}  // namespace rc
