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
// What bounds it on an H100: device-memory traffic, one read and one write
// of the band (2 x 201 MB at n = 24M, about 0.12 ms at 3.35 TB/s), once
// the a-point DFT costs a few flops per point. Taken directly it costs 4a
// flops per point (19 GFLOP at a = 96) and bounds the pass instead.
//
// What the design does about it: a = 2^p * q with q odd, taken as a
// Stockham chain inside one tile of 64 columns: first the q-point DFTs
// (radix 3 in registers; a direct q-point sum for any other odd q, e.g.
// q = 127), then the 2^p part as radix-16/8/4/2 stages in registers
// (96 = 3 * 8 * 4), with the inner twiddles W_a from a table of a entries.
// That is about 10x fewer operations per point at a = 96. Each thread
// holds two neighbouring columns (16-byte accesses, 512-byte runs per row
// and warp); stages exchange through shared memory (a x 64 points,
// 48 KB at a = 96; two blocks per SM at 128 registers a thread; more
// resident blocks measured slower). The outer twiddle W_n^(k1*j2)
// has k1*j2 < n, so it needs no reduction, and n is not a power of two:
// it comes from a two-level table built on the host in float64
// (hi[r >> 12] * lo[r & 4095], kernels/fft_mixed.py mixed_table), which
// measured faster than sincospif of an exactly reduced phase.
#include "fft_common.cuh"

namespace rc {

constexpr int kMixLanes = 32;    // column pairs per block (64 columns)
constexpr int kMixWarps = 8;     // warps per block
constexpr int kMixMaxA = 128;
constexpr int kMixSlots = 16;    // points of a column a thread holds
constexpr int kMixMaxStages = 4;
constexpr int kTwBits = 12;        // mixed_table's lo has 2^12 entries
constexpr int kTw = 1 << kTwBits;

// The a-point DFT as stages: stage 0 is the q-point one when q > 1
// (Ns = 1), then the power-of-two radices; kernels/fft_mixed.py
// column_stages() mirrors this.
struct Mixed {
  int a;
  int nst;
  int radix[kMixMaxStages];
  int ns[kMixMaxStages];
  long long b2;   // float4 (column pairs) per row: b / 2
  long long lo;   // table offsets: W_a^e at 0, lo at a, hi at a + 4096
  long long hi;
};

__device__ __forceinline__ void dft3(float2 (&x)[3], float sign) {
  const float2 s = cadd(x[1], x[2]), d = csub(x[1], x[2]);
  const float2 t = make_float2(x[0].x - 0.5f * s.x, x[0].y - 0.5f * s.y);
  const float k = sign * 0.866025403784438647f;
  x[0] = cadd(x[0], s);
  x[1] = make_float2(t.x - k * d.y, t.y + k * d.x);
  x[2] = make_float2(t.x + k * d.y, t.y - k * d.x);
}

template <int R>
__device__ __forceinline__ void dft_any(float2 (&x)[R], float sign) {
  if constexpr (R == 3) {
    dft3(x, sign);
  } else {
    dft<R>(x, sign);
  }
}

// Butterfly b = g + i*8 of a radix-R stage takes rows b + q*a/R, twiddled
// by W_{Ns*R}^(q*(b mod Ns)) = W_a^(q*(b mod Ns)*a/(Ns*R)); its output q
// goes to slot i*R + q and belongs at row (b - b mod Ns)*R + b mod Ns +
// q*Ns.
template <int R>
__device__ __forceinline__ void mix_stage(float2 (&u0)[kMixSlots],
                                          float2 (&u1)[kMixSlots],
                                          const float4* tile, const float2* wa,
                                          int a, int Ns, int g, int lane,
                                          float sign) {
  constexpr int NB = kMixSlots / R;
  const int nb = a / R;
  const int step = a / (Ns * R);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = g + i * kMixWarps;
    if (b < nb) {
      const int bm = b % Ns;
      float2 x0[R], x1[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float4 w4 = tile[(b + q * nb) * kMixLanes + lane];
        x0[q] = make_float2(w4.x, w4.y);
        x1[q] = make_float2(w4.z, w4.w);
        if (q > 0 && Ns > 1) {
          const float2 w = wa[q * bm * step];
          x0[q] = cmul(x0[q], w);
          x1[q] = cmul(x1[q], w);
        }
      }
      dft_any<R>(x0, sign);
      dft_any<R>(x1, sign);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        u0[i * R + q] = x0[q];
        u1[i * R + q] = x1[q];
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void mix_write(const float2 (&u0)[kMixSlots],
                                          const float2 (&u1)[kMixSlots],
                                          float4* tile, int a, int Ns, int g,
                                          int lane) {
  constexpr int NB = kMixSlots / R;
  const int nb = a / R;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = g + i * kMixWarps;
    if (b < nb) {
      const int bm = b % Ns;
      const int base = (b - bm) * R + bm;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float2 x = u0[i * R + q], y = u1[i * R + q];
        tile[(base + q * Ns) * kMixLanes + lane] =
            make_float4(x.x, x.y, y.x, y.y);
      }
    }
  }
}

// Row k1 = b + q*Ns of the last radix-R stage (b < Ns there) to device
// memory, times W_n^(k1*j2) for the thread's two columns.
__device__ __forceinline__ float2 outer_tw(const float2* __restrict__ tab,
                                           const Mixed& d, long long r) {
  return cmul(__ldg(&tab[d.hi + (r >> kTwBits)]),
              __ldg(&tab[d.lo + (r & (kTw - 1))]));
}

__device__ __forceinline__ void store_pair(float4* __restrict__ out,
                                           const float2* __restrict__ tab,
                                           const Mixed& d, int k1,
                                           long long c2, float2 x, float2 y) {
  const long long j2 = 2 * c2;
  x = cmul(x, outer_tw(tab, d, (long long)k1 * j2));
  y = cmul(y, outer_tw(tab, d, (long long)k1 * (j2 + 1)));
  out[(long long)k1 * d.b2 + c2] = make_float4(x.x, x.y, y.x, y.y);
}

template <int R>
__device__ __forceinline__ void mix_store(const float2 (&u0)[kMixSlots],
                                          const float2 (&u1)[kMixSlots],
                                          float4* __restrict__ out,
                                          const float2* __restrict__ tab,
                                          const Mixed& d, int Ns, int g,
                                          long long c2) {
  constexpr int NB = kMixSlots / R;
  const int nb = d.a / R;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int b = g + i * kMixWarps;
    if (b < nb) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        store_pair(out, tab, d, b + q * Ns, c2, u0[i * R + q], u1[i * R + q]);
      }
    }
  }
}

// The q-point DFTs of stage 0 (Ns = 1) as direct sums, for odd q other
// than 3: output o = b*q + k (slot i of o = g + i*8) is
// sum_m row(b + m*a/q) * W_q^(m*k), W_q^e = W_a^(e*a/q).
__device__ __forceinline__ void mix_direct(float2 (&u0)[kMixSlots],
                                           float2 (&u1)[kMixSlots],
                                           const float4* tile, const float2* wa,
                                           int a, int q, int g, int lane) {
  const int nb = a / q;
#pragma unroll
  for (int i = 0; i < kMixSlots; ++i) {
    const int o = g + i * kMixWarps;
    if (o < a) {
      const int b = o / q, k = o - (o / q) * q;
      float2 s0 = make_float2(0.f, 0.f), s1 = s0;
      int e = 0;  // (m*k) mod q
      for (int m = 0; m < q; ++m) {
        const float4 w4 = tile[(b + m * nb) * kMixLanes + lane];
        const float2 w = wa[e * nb];
        s0 = cadd(s0, cmul(make_float2(w4.x, w4.y), w));
        s1 = cadd(s1, cmul(make_float2(w4.z, w4.w), w));
        e += k;
        if (e >= q) e -= q;
      }
      u0[i] = s0;
      u1[i] = s1;
    }
  }
}

__global__ void __launch_bounds__(kMixLanes * kMixWarps, 2)
    mixed_column_kernel(const float4* __restrict__ in,
                        float4* __restrict__ out,
                        const float2* __restrict__ tab, Mixed d, float sign) {
  extern __shared__ float4 tile[];  // a rows x 32 column pairs, then W_a
  float2* wa = reinterpret_cast<float2*>(tile + d.a * kMixLanes);
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const long long c2 = (long long)blockIdx.x * kMixLanes + lane;
  const int a = d.a;

  for (int e = threadIdx.x; e < a; e += blockDim.x) wa[e] = tab[e];
  for (int j1 = g; j1 < a; j1 += kMixWarps) {
    tile[j1 * kMixLanes + lane] = in[(long long)j1 * d.b2 + c2];
  }
  __syncthreads();

  float2 u0[kMixSlots], u1[kMixSlots];
  for (int st = 0; st < d.nst; ++st) {
    const int r = d.radix[st], Ns = d.ns[st];
    const bool last = st + 1 == d.nst;
    const bool direct = (r & 1) && r != 3;
    switch (r) {
      case 2: mix_stage<2>(u0, u1, tile, wa, a, Ns, g, lane, sign); break;
      case 3: mix_stage<3>(u0, u1, tile, wa, a, Ns, g, lane, sign); break;
      case 4: mix_stage<4>(u0, u1, tile, wa, a, Ns, g, lane, sign); break;
      case 8: mix_stage<8>(u0, u1, tile, wa, a, Ns, g, lane, sign); break;
      case 16: mix_stage<16>(u0, u1, tile, wa, a, Ns, g, lane, sign); break;
      default: mix_direct(u0, u1, tile, wa, a, r, g, lane); break;
    }
    if (last) {
      if (direct) {
#pragma unroll
        for (int i = 0; i < kMixSlots; ++i) {
          const int o = g + i * kMixWarps;
          if (o < a) store_pair(out, tab, d, o, c2, u0[i], u1[i]);
        }
        return;
      }
      switch (r) {
        case 2: mix_store<2>(u0, u1, out, tab, d, Ns, g, c2); break;
        case 3: mix_store<3>(u0, u1, out, tab, d, Ns, g, c2); break;
        case 4: mix_store<4>(u0, u1, out, tab, d, Ns, g, c2); break;
        case 8: mix_store<8>(u0, u1, out, tab, d, Ns, g, c2); break;
        default: mix_store<16>(u0, u1, out, tab, d, Ns, g, c2); break;
      }
      return;
    }
    __syncthreads();
    if (direct) {
#pragma unroll
      for (int i = 0; i < kMixSlots; ++i) {
        const int o = g + i * kMixWarps;
        if (o < a) {
          tile[o * kMixLanes + lane] =
              make_float4(u0[i].x, u0[i].y, u1[i].x, u1[i].y);
        }
      }
    } else {
      switch (r) {
        case 2: mix_write<2>(u0, u1, tile, a, Ns, g, lane); break;
        case 3: mix_write<3>(u0, u1, tile, a, Ns, g, lane); break;
        case 4: mix_write<4>(u0, u1, tile, a, Ns, g, lane); break;
        case 8: mix_write<8>(u0, u1, tile, a, Ns, g, lane); break;
        default: mix_write<16>(u0, u1, tile, a, Ns, g, lane); break;
      }
    }
    __syncthreads();
  }
}

}  // namespace rc

// Column pass: x (a, b) row-major -> T (a, b) row-major, both complex64;
// `table` is mixed_table(a, b, sign): W_a^e (a entries), then lo (4096),
// then hi (ceil(a*b / 4096)), each exp(sign*2*pi*i*(.)/(.)) in complex64.
extern "C" int rc_mixed_column(const void* in, void* out, int a, long long b,
                               int sign, const void* table, void* stream) {
  using namespace rc;
  if (a < 2 || a > kMixMaxA || b < 2 * kMixLanes || (b & (b - 1)) != 0 ||
      !table) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)in | (uintptr_t)out) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  Mixed d;
  d.a = a;
  d.nst = 0;
  int q = a, p = 0;
  while ((q & 1) == 0) {
    q >>= 1;
    ++p;
  }
  int Ns = 1;
  if (q > 1) {
    d.radix[d.nst] = q;
    d.ns[d.nst++] = 1;
    Ns = q;
  }
  if (p > 0) {
    const int np = (p + 3) / 4;
    for (int st = 0; st < np; ++st) {
      const int bits = p / np + (st < p % np ? 1 : 0);
      d.radix[d.nst] = 1 << bits;
      d.ns[d.nst++] = Ns;
      Ns <<= bits;
    }
  }
  d.b2 = b / 2;
  d.lo = a;
  d.hi = a + kTw;
  const long long blocks = b / (2 * kMixLanes);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float4) * (size_t)a * kMixLanes +
                      sizeof(float2) * (size_t)a;
  cudaError_t err = cudaFuncSetAttribute(
      mixed_column_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mixed_column_kernel<<<(unsigned)blocks, kMixLanes * kMixWarps, smem,
                        (cudaStream_t)stream>>>(
      (const float4*)in, (float4*)out, (const float2*)table, d,
      sign < 0 ? -1.0f : 1.0f);
  return (int)cudaGetLastError();
}
