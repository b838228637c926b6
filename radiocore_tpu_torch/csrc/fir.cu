// K-FIR: direct causal real FIR, y[t] = sum_k taps[k] * x[t - k], with the
// T-1 samples before each row taken from `hist` (zeros when null).
//
// Replaces radiocore_tpu/kernels/fir_pallas.py `_fir_blocks` (body
// `_fir_kernel`, vmap wrapper `_batched_call`, entry `fir_causal_pallas`),
// which ran the FIR as banded-Toeplitz matmuls on the TPU's MXU.
//
// What bounds it on an H100: by the bytes it must move, one read of x and
// one write of y (8 bytes per sample; the halo re-read adds (T-1)/kTile);
// by its operations, T float32 FMAs per sample, which at the de-emphasis
// size (51 taps) take about as long as the bytes. A thread that computes
// one output and reads both operands of every FMA from shared memory is
// bound by neither: it makes two shared loads per FMA, and an SM takes one
// warp-wide load a cycle where it takes four warp-wide FMAs.
//
// What the design does about it:
//  - Each thread computes kR = 8 consecutive outputs and keeps the window
//    of x they need in registers. The taps go by in chunks of kC = 8: a
//    chunk is kR*kC = 64 FMAs against 8 new samples (two 16-byte shared
//    loads) and 8 taps (two 16-byte loads of one address for the whole
//    warp, a broadcast). The window is kR/kC + 1 blocks of kC samples;
//    from one chunk to the next every block moves up one place and the
//    oldest place takes the new samples. The chunk loop is unrolled over
//    the kR/kC + 1 places, so the rotation is a renaming of registers:
//    every register index is a compile-time constant, nothing is copied
//    and nothing falls to local memory.
//  - The taps are padded with zeros to whole chunks and staged in shared
//    memory, for any 1 <= T <= 4096 in one code path. (__constant__ memory
//    would need an upload ordered on the caller's stream and keyed on the
//    taps; the broadcast loads are 2 of the chunk's 68 instructions.)
//  - The tile of x (kThreads*kR samples and the halo, rounded up to whole
//    chunks) is staged in shared memory with 16-byte loads where the row's
//    base is 16-byte aligned and the run lies inside the row, and with
//    scalar loads otherwise (a strided view's odd rows, the history, the
//    ragged end). Thread i reads 16 bytes at sample kR*i + const: with kR =
//    8 that is a stride of 32 bytes, a 2-way bank conflict in every
//    quarter-warp. The layout is therefore skewed: 4 floats of padding
//    after every kR samples (skew()), which puts the 8 threads of a
//    quarter-warp on the 8 distinct 16-byte bank groups. (Interleaving the
//    threads' output runs would halve the FMAs per loaded sample; warp
//    shuffles would add an instruction per sample.)
//  - The outputs go back through shared memory and leave as the fill
//    came, 16 bytes a thread with a warp on 512 neighbouring bytes, where
//    y's row is 16-byte aligned: a thread's own run would leave as halves
//    of 32-byte sectors. Rows and tiles are one flat grid, so any batch
//    works.
// In-order float32 FMA sums: no TF32, no tensor cores.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kR = 8;                  // outputs per thread
constexpr int kC = 8;                  // taps per chunk, samples per block
constexpr int kBlocks = kR / kC + 1;   // blocks of the register window
constexpr int kThreads = 256;
// Blocks per SM the kernel is built for: 32 registers a thread (no spill),
// so that one block's fill overlaps the others' FMAs.
constexpr int kBlocksPerSm = 8;
constexpr int kTile = kThreads * kR;   // outputs per thread block
constexpr int kMaxTaps = 4096;

static_assert(kR % kC == 0 && kC % 4 == 0, "whole 16-byte blocks");
static_assert((kR & (kR - 1)) == 0, "skew() shifts by log2(kR)");

// Shared-memory position of sample i of the tile: 4 floats of padding after
// every kR samples when a thread's run is longer than one 16-byte access.
__host__ __device__ constexpr int skew(int i) {
  return kR >= 8 ? i + (i / kR) * 4 : i;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kC floats from a 16-byte aligned place in shared memory.
__device__ __forceinline__ void load_block(float (&dst)[kC],
                                           const float* src) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kC / 4; ++i) {
    const float4 v = src4[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

// One chunk: taps q*kC .. q*kC + kC - 1 on the window whose place PH takes
// the new (oldest) block. Block b of the window, b = -1 (oldest) ..
// kR/kC - 1, lives in place (b + 1 - PH) mod kBlocks during chunk q with
// q mod kBlocks == PH.
template <int PH>
__device__ __forceinline__ void chunk(float (&acc)[kR],
                                      float (&w)[kBlocks][kC],
                                      const float* __restrict__ xs,
                                      const float* __restrict__ tp, int u) {
  constexpr int kNew = (kBlocks - PH) % kBlocks;
  // The kC samples before u (u is a multiple of kC: one block of the skew).
  load_block(w[kNew], xs + skew(u - kC));
  float tap[kC];
  load_block(tap, tp);
  // Output j at tap c reads sample u + j - c: block floor((j - c)/kC).
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      constexpr int kOff = kC;  // keeps the division below on non-negatives
      const int d = j - c + kOff;
      const int b = d / kC - 1;
      const int o = d % kC;
      acc[j] = fmaf(tap[c], w[(b + 1 - PH + kBlocks) % kBlocks][o], acc[j]);
    }
  }
}

template <int PH>
struct Chunks {
  // Chunks q0 + PH .. of this round of kBlocks; false when nq is reached.
  static __device__ __forceinline__ bool run(float (&acc)[kR],
                                             float (&w)[kBlocks][kC],
                                             const float* xs, const float* tp,
                                             int u0, int q0, int nq) {
    if (q0 + PH >= nq) return false;
    chunk<PH>(acc, w, xs, tp + (q0 + PH) * kC, u0 - (q0 + PH) * kC);
    return Chunks<PH + 1>::run(acc, w, xs, tp, u0, q0, nq);
  }
};

template <>
struct Chunks<kBlocks> {
  static __device__ __forceinline__ bool run(float (&)[kR],
                                             float (&)[kBlocks][kC],
                                             const float*, const float*, int,
                                             int, int) {
    return true;
  }
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fir_kernel(const float* __restrict__ x, long long x_stride,
               const float* __restrict__ hist, long long hist_stride,
               const float* __restrict__ taps, float* __restrict__ y,
               long long n, int T, int nq, long long ntiles) {
  extern __shared__ float4 sh4[];
  float* tp = reinterpret_cast<float*>(sh4);  // nq*kC taps, zero padded
  float* xs = tp + nq * kC;                   // skewed tile, halo first
  const int H = nq * kC;                      // staged halo, >= T - 1
  // Fewer than 2^31 blocks (rc_fir): 32-bit divisions, where 64-bit ones
  // are subroutine calls.
  const long long row = blockIdx.x / (unsigned)ntiles;
  const long long tile0 = (long long)(blockIdx.x % (unsigned)ntiles) * kTile;
  const float* xr = x + row * x_stride;
  const float* hr = hist ? hist + row * hist_stride + (T - 1) : nullptr;

  // Sample p of the row: x, the history before it, zeros around both.
  auto sample = [&](long long p) -> float {
    if (p >= n) return 0.f;
    if (p >= 0) return xr[p];
    return (hr && p >= -(long long)(T - 1)) ? hr[p] : 0.f;
  };
  // Samples 4v .. 4v + 3 of the staged tile (position 0 is sample
  // tile0 - H of the row, a multiple of 4).
  const bool vec = aligned16(xr);
  auto load4 = [&](int v) -> float4 {
    const long long p = tile0 - H + 4 * v;
    if (vec && p >= 0 && p + 3 < n) {
      return *reinterpret_cast<const float4*>(xr + p);
    }
    return make_float4(sample(p), sample(p + 1), sample(p + 2),
                       sample(p + 3));
  };
  auto store4 = [&](int v, float4 val) {
    *reinterpret_cast<float4*>(xs + skew(4 * v)) = val;
  };
  // The fill: every load of a thread is started before its first store, so
  // that a block waits for device memory once, not once per access. The
  // tile proper is kR/4 16-byte loads a thread; the halo and the taps take
  // one more each (1024 samples of halo, 256 taps) and a loop beyond that.
  const int tid = threadIdx.x;
  float4 body[kR / 4];
#pragma unroll
  for (int i = 0; i < kR / 4; ++i) body[i] = load4(H / 4 + tid + i * kThreads);
  float4 halo = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < H / 4) halo = load4(tid);
  const float tap = tid < T ? taps[tid] : 0.f;
#pragma unroll
  for (int i = 0; i < kR / 4; ++i) store4(H / 4 + tid + i * kThreads, body[i]);
  if (tid < H / 4) store4(tid, halo);
  if (tid < H) tp[tid] = tap;
  for (int v = tid + kThreads; v < H / 4; v += kThreads) store4(v, load4(v));
  for (int i = tid + kThreads; i < H; i += kThreads) {
    tp[i] = i < T ? taps[i] : 0.f;
  }
  __syncthreads();

  // u0: the tile position of the thread's first output.
  const int u0 = H + tid * kR;
  float acc[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) acc[j] = 0.f;
  if (tile0 + (long long)tid * kR < n) {
    float w[kBlocks][kC];
    // Chunk 0 finds blocks 0 .. kR/kC - 1 (the outputs' own samples) in
    // places 1 .. kR/kC.
#pragma unroll
    for (int b = 0; b < kR / kC; ++b) {
      load_block(w[b + 1], xs + skew(u0 + b * kC));
    }
    for (int q0 = 0; q0 < nq; q0 += kBlocks) {
      if (!Chunks<0>::run(acc, w, xs, tp, u0, q0, nq)) break;
    }
  }

  // The store: a thread's own kR outputs would leave as 16-byte halves of
  // 32-byte sectors, two instructions apart. They go back to the tile's
  // place in shared memory instead (every thread has read its window), and
  // leave as the fill came: 16 bytes a thread, a warp on 512 neighbouring
  // bytes.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kR / 4; ++i) {
    *reinterpret_cast<float4*>(xs + skew(tid * kR + 4 * i)) = make_float4(
        acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  float* yr = y + row * n + tile0;
  const long long left = n - tile0;  // outputs of this tile inside the row
  const bool yvec = aligned16(yr);
#pragma unroll
  for (int i = 0; i < kR / 4; ++i) {
    const int o = 4 * (tid + i * kThreads);
    if (o >= left) break;
    const float4 val = *reinterpret_cast<const float4*>(xs + skew(o));
    if (yvec && o + 3 < left) {
      *reinterpret_cast<float4*>(yr + o) = val;
    } else {
      yr[o] = val.x;
      if (o + 1 < left) yr[o + 1] = val.y;
      if (o + 2 < left) yr[o + 2] = val.z;
      if (o + 3 < left) yr[o + 3] = val.w;
    }
  }
}

}  // namespace

extern "C" int rc_fir(const void* x, long long x_stride, const void* hist,
                      long long hist_stride, const void* taps, void* y,
                      long long rows, long long n, int T, void* stream) {
  if (rows < 1 || n < 1 || T < 1 || T > kMaxTaps) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntiles = (n + kTile - 1) / kTile;
  const long long blocks = rows * ntiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // Whole chunks that cover the T taps and the T - 1 samples of halo.
  const int nq = (T + kC - 1) / kC;
  const size_t smem =
      sizeof(float) * ((size_t)nq * kC + skew(nq * kC + kTile));
  if (smem > 48 * 1024) {  // long tap sets only: above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fir_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, x_stride, (const float*)hist, hist_stride,
      (const float*)taps, (float*)y, n, T, nq, ntiles);
  return (int)cudaGetLastError();
}
