// Shared core of K-FFT (fft_rows.cu), K-EXTRACT (extract.cu), K-MIXED's
// rows (fft_mixed.cu) and K-XDEMOD (extract_demod.cu): one pass of a
// multi-pass power-of-two FFT over interleaved complex64 (float2).
//
// A pass computes a batch of length-L sub-FFTs (L <= 4096, so a sub-FFT is
// at most 32 KB of shared memory). Sub-FFT (b0, b1, s) reads element j at
//     in  + b0*ib0 + b1*ib1 + s*is + j*ij
// and writes element k at
//     out + b0*ob0 + b1*ob1 + s*os + k*ok,
// optionally multiplied by the four-step twiddle exp(sign*2*pi*i*(s*k)/tw_n).
// The host plan (kernels/fft_rows.py) chains two passes for rows up to
// 4096^2 points and three above that. A block holds P sub-FFTs with
// consecutive s, so a strided load or store still moves runs of P
// neighbouring elements.
//
// Inside the block: bit-reversed placement at load time, then the log2(L)
// radix-2 decimation-in-time stages, fused in pairs, in shared memory
// against a table of exp(sign*2*pi*i*k/L) built per block (fft_smem).
//
// Twiddle phases are reduced mod n on integers first. Every tw_n here is a
// power of two, so the argument 2*r/n of sincospif is exact in float32 and
// the phase error is that of sincospif alone (about one ulp), independent
// of n. Built without --use_fast_math for the same reason.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

// Each instantiation of fft_pass_kernel lives in one source only (LOAD,
// STORE): fft_rows.cu (0, 0), extract.cu (1, 1), (1, 0), (0, 1),
// extract_demod.cu (0, 2).
namespace rc {

constexpr int kMaxSub = 4096;        // longest sub-FFT of one pass
constexpr int kBlockPoints = 16384;  // P*L per block: 128 KB of float2

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

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Closed-form hann window (times s_norm) at raw coordinate k, plus the
// Nyquist fold u[0] = (x[0] + next station's x[0]) * w[0].
__device__ __forceinline__ float2 extract_load(const float2* __restrict__ spec,
                                               long long off,
                                               const Extract& e) {
  const long long k = off & (e.m - 1);
  const float w = 0.5f * e.s_norm *
                  (1.0f + cospif(2.0f * (float)(k - e.m / 2) / (float)e.n));
  float2 x = spec[(e.a0 + off) % e.n];
  if (k == 0) {
    const float2 nx = spec[(e.a0 + off + e.m) % e.n];
    x.x += nx.x;
    x.y += nx.y;
  }
  return make_float2(x.x * w, x.y * w);
}

// tw[k] = exp(sign*2*pi*i*k/L) for k < L/2.
__device__ __forceinline__ void fill_table(float2* tw, int L, float sign) {
  for (int k = threadIdx.x; k < (L >> 1); k += blockDim.x) {
    float sn, cs;
    sincospif(2.0f * (float)k / (float)L, &sn, &cs);
    tw[k] = make_float2(cs, sign * sn);
  }
}

__device__ __forceinline__ int bitrev(int j, int lg) {
  return (int)(__brev((unsigned)j) >> (32 - lg));
}

// In-place DFT of `rows` sub-FFTs of L = 2^lg points, row p at
// buf + p*pitch in bit-reversed order, against the table `tw`; the result
// is in natural order. Every thread of the block calls it; it starts with
// no barrier (the caller syncs after loading) and ends with one.
//
// An odd log2(L) starts with one radix-2 stage; the rest go two at a
// time: stages st and st+1 on the four points i0 + {0,1,2,3}*2^st, held
// in registers (the same operations as two radix-2 stages, with half the
// shared-memory round trips and barriers).
__device__ __forceinline__ void fft_smem(float2* buf, const float2* tw, int L,
                                         int lg, int rows, int pitch) {
  int st = 0;
  if (lg & 1) {
    const int nb = rows * (L >> 1);
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      float2* row = buf + (b >> (lg - 1)) * pitch + 2 * (b & ((L >> 1) - 1));
      const float2 u = row[0], v = row[1];
      row[0] = make_float2(u.x + v.x, u.y + v.y);
      row[1] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
    st = 1;
  }
  const int quarter_n = L >> 2;
  const int nq = rows * quarter_n;
  for (; st < lg; st += 2) {
    const int h = 1 << st;
    const int tsh = lg - 2 - st;  // W_{4h}^e = tw[e << tsh]
    for (int b = threadIdx.x; b < nq; b += blockDim.x) {
      const int p = b >> (lg - 2);
      const int q = b & (quarter_n - 1);
      const int pos = q & (h - 1);
      float2* row = buf + p * pitch + ((q >> st) << (st + 2)) + pos;
      float2 a0 = row[0], a1 = row[h], a2 = row[2 * h], a3 = row[3 * h];
      const float2 w1 = tw[pos << (tsh + 1)];  // W_{2h}^pos
      float2 t = cmul(a1, w1);
      a1 = make_float2(a0.x - t.x, a0.y - t.y);
      a0 = make_float2(a0.x + t.x, a0.y + t.y);
      t = cmul(a3, w1);
      a3 = make_float2(a2.x - t.x, a2.y - t.y);
      a2 = make_float2(a2.x + t.x, a2.y + t.y);
      t = cmul(a2, tw[pos << tsh]);            // W_{4h}^pos
      row[0] = make_float2(a0.x + t.x, a0.y + t.y);
      row[2 * h] = make_float2(a0.x - t.x, a0.y - t.y);
      t = cmul(a3, tw[(pos + h) << tsh]);      // W_{4h}^(pos+h)
      row[h] = make_float2(a1.x + t.x, a1.y + t.y);
      row[3 * h] = make_float2(a1.x - t.x, a1.y - t.y);
    }
    __syncthreads();
  }
}

template <int LOAD, int STORE>
__global__ void __launch_bounds__(1024)
    fft_pass_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                    Pass d, Extract e) {
  extern __shared__ float2 smem[];
  const int L = d.L, lg = d.lg, P = d.P;
  const int pitch = L + 1;  // pads the rows apart in the banks
  float2* tw = smem;
  float2* buf = smem + (L >> 1);

  const long long nsb = (d.S + P - 1) / P;
  long long g = blockIdx.x;
  const long long s0 = (g % nsb) * P;
  g /= nsb;
  const long long b1 = g % d.B1;
  const long long b0 = g / d.B1;
  const long long in_base = b0 * d.ib0 + b1 * d.ib1;
  const long long out_base = b0 * d.ob0 + b1 * d.ob1;

  fill_table(tw, L, d.sign);

  // Load: walk the unit-stride index fastest so a warp reads neighbours.
  const int total = P << lg;
  const bool jfast = (d.ij == 1);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int p, j;
    if (jfast) {
      j = idx & (L - 1);
      p = idx >> lg;
    } else {
      p = idx & (P - 1);
      j = idx >> d.lgP;
    }
    const long long s = s0 + p;
    float2 v = make_float2(0.f, 0.f);
    if (s < d.S) {
      const long long off = in_base + s * d.is + (long long)j * d.ij;
      if (LOAD == kLoadStrided) {
        v = in[off];
      } else {
        v = extract_load(in, off, e);
      }
    }
    buf[p * pitch + bitrev(j, lg)] = v;
  }
  __syncthreads();

  fft_smem(buf, tw, L, lg, P, pitch);

  const bool kfast = (d.ok == 1);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int p, k;
    if (kfast) {
      k = idx & (L - 1);
      p = idx >> lg;
    } else {
      p = idx & (P - 1);
      k = idx >> d.lgP;
    }
    const long long s = s0 + p;
    if (s >= d.S) continue;
    const long long rel = s * d.os + (long long)k * d.ok;
    if (STORE == kStoreKeep && rel >= d.keep) continue;
    float2 v = buf[p * pitch + k];
    const long long off = out_base + rel;
    if (STORE != kStoreFlip) {
      if (d.tw_n) {
        const long long r = (s * k) & (d.tw_n - 1);
        float sn, cs;
        sincospif(2.0f * (float)r / (float)d.tw_n, &sn, &cs);
        v = cmul(v, make_float2(cs, d.sign * sn));
      }
    } else if (off & 1) {
      // (-1)^t roll flip; m is even, so t = off mod m has off's parity.
      v = make_float2(-v.x, -v.y);
    }
    out[off] = v;
  }
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
  d.sign = sign < 0 ? -1.0f : 1.0f;
  d.keep = keep;
  if (d.lg < 1 || L > kMaxSub || d.lgP < 0 || (long long)P * L > kBlockPoints ||
      S < 1 || B0 < 1 || B1 < 1 || (tw_n && log2_exact(tw_n) < 0) ||
      (STORE == kStoreKeep && keep < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = B0 * B1 * ((S + P - 1) / P);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float2) * ((size_t)(L / 2) + (size_t)P * (L + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fft_pass_kernel<LOAD, STORE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = std::min(1024, std::max(32, P * L / 4));
  fft_pass_kernel<LOAD, STORE><<<(unsigned)blocks, threads, smem, stream>>>(
      (const float2*)in, (float2*)out, d, e);
  return (int)cudaGetLastError();
}

}  // namespace rc
