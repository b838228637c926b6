// K-BANDFFT: one FFT of n = a*b points, a = 3200 and b = 3200 or 3125 (the
// sides whose chains are built in; the 10 MS/s band is n = 10^7 = 3200 *
// 3125), in two passes over device memory.
//
// Replaces no TPU kernel: the reference sends such a size to XLA's FFT
// (radiocore_tpu/ops/fft.py); on the card it went to cuFFT, which takes
// 10^7 = 625 * 128 * 125 in three passes, each reading and writing the
// 80 MB band (PERF.md §5, the breakdowns). With K-MIXED's index
// convention (fft_mixed.cu), j = b*j1 + j2 and k = k1 + a*k2:
//     T[k1, j2] = W_n^(k1*j2) * sum_j1 x[b*j1 + j2] W_a^(j1*k1)   (column pass)
//     X[k1 + a*k2] = sum_j2 T[k1, j2] W_b^(j2*k2)                  (row pass)
// Both sides fit on chip (3200 and 3125 points, 25 KB a sequence), so each
// pass reads and writes the band once: 320 MB for the transform, where
// cuFFT moves 480 MB.
//
// What bounds it on an H100: device-memory traffic, 16 B a point a pass
// (0.048 ms a pass at 3.35 TB/s), if the instructions of the DFTs, the
// twiddles and the exchanges between stages stay under what an SM can
// issue beside the copies (the port's power-of-two passes did not:
// fft_common.cuh).
//
// What the design does about it:
//  - A unit of work is kBandW = 4 neighbouring sequences: 4 columns j2 (the
//    column pass, runs of 32 B on the strided read) or 4 rows k1 (the row
//    pass, runs of 32 B on the strided store). Every thread holds points
//    of one sequence, kBandT = 128 threads a sequence, 512 a block.
//  - Blocks are persistent, one an SM (two tiles of 4 x L points and the
//    pass's stage twiddles take up to 230 KB of shared memory): a block
//    takes units blockIdx.x, blockIdx.x + gridDim.x, ..., so the blocks on
//    the card work on neighbouring units at any time, and the next unit's
//    tile comes in by cp.async into the second tile, a third of it ahead
//    of each stage of the unit the block transforms.
//  - A sequence's DFT is a chain of radix-25/16/9/8/5/4/3/2 stages in
//    registers (radix 25 and 9 as 5x5 and 3x3 with constant twiddles),
//    exchanging through the tile in shared memory. The first stage reads
//    the tile as loaded, every butterfly of a thread before a barrier,
//    and writes its outputs where an in-place decimation-in-time chain
//    over a digit-reversed load would have them (kernels/fft_band.py
//    first_points); the later stages run in place, one butterfly a thread
//    at a time, a barrier a stage, and the last leaves natural order.
//    (Stockham stages, every butterfly in registers before any write,
//    spilled: 0.559 ms for 10^7 points.) The two chains, 3200 = 25*16*8
//    and 3125 = 25*25*5 (kernels/fft_band.py CHAINS), are built in with
//    every offset and bound a constant (band_chain: 110-120 registers,
//    where a chain read from a plan at run time spilled), their first
//    stage ordered so that a quarter warp's reads and writes fall in
//    distinct banks (band_first_bf).
//  - Stage twiddles come from a table per pass ([q-1][bm] a stage, built
//    in float64 on the host and rounded once), copied into shared memory
//    once a block. The outer twiddle W_n^(k1*j2) is U[j2 >> 5][k1] *
//    V[j2 & 31][k1] (tables of 2.5 MB and 0.8 MB at n = 10^7, in the L2):
//    a warp's lanes hold neighbouring k1, so the reads are neighbours,
//    where a table indexed by k1*j2 would scatter them; a thread reads
//    W_n^(bf*j2) once and steps it by a product a round, and W_n^(q*Ns*j2)
//    once a unit.
//  - The column pass stores T in the order the row pass reads it: block
//    of 8 row groups, tile of columns (4j2' .. 4j2' + 3), row group (4k1'
//    .. 4k1' + 3), column, row. A column unit then writes runs of 1 KB,
//    and a row unit reads 128-B runs 1 KB apart, which the units beside it
//    read between. The row pass's last stage stores element k2 of row k1
//    at k1 + a*k2: natural order, no transpose pass. The split puts a
//    multiple of 4 in a (3200), so that those stores fill whole 32-B
//    sectors; with a = 3125 each straddled two sectors, written by two
//    blocks, and the row pass took twice as long.
//  - The backward sign is the forward transform of the conjugate,
//    conjugated: the column pass conjugates what it reads, the row pass
//    what it stores, so every table is the forward one.
#include "fft_common.cuh"

namespace rc {

constexpr int kBandW = 4;                        // sequences a unit
constexpr int kBandT = 128;                      // threads a sequence
constexpr int kBandThreads = kBandW * kBandT;    // threads a block
// Two tiles of 4 x L complex64 and the pass's L - 1 stage twiddles in
// shared memory: 230 392 B at L = 3200, of the 232 448 a block may have.
constexpr int kBandMaxL = 3200;
static_assert(sizeof(float2) * (2 * kBandW * kBandMaxL + kBandMaxL - 1) <=
                  232448,
              "two tiles and the stage twiddles fit a block's shared memory");
// The first radix of both chains: the column pass's first-stage table
// (`first`) holds a / kBandR0 entries.
constexpr int kBandR0 = 25;
constexpr int kBandUBits = 5;    // outer twiddle: j2 = 32 * (j2 >> 5) + (j2 & 31)
// Row groups a block of the scratch holds side by side (band_put: k1 >> 5
// is the block, (k1 >> 2) & 7 the group in it).
constexpr int kBandGroups = 8;

struct BandPass {
  int L;            // points a sequence
  int a, b;         // the split, n = a*b
  int units;        // units a transform: ceil(b/4) tiles of columns or
                    // ceil(a/4) groups of rows
  int total;        // units of the whole batch
  long long n;
  int tiles;        // tiles of columns: ceil(b/4)
  long long gs;     // points of kBandGroups row groups in the scratch:
                    // kBandGroups * 16 * tiles
  long long ss;     // points of one transform in the scratch:
                    // ceil(ceil(a/4) / kBandGroups) * gs
  long long tw0;    // the pass's stage twiddles (L - 1) in tab
  long long u_off;  // the outer twiddle tables in tab (column pass)
  long long v_off;
  bool conj;        // the backward sign
};

// Forward twiddles of the in-register radix-9 and radix-25 DFTs,
// exp(-2*pi*i*m/R), rounded once from double.
static __constant__ float2 c_band_w9[9] = {
    {1.0f, 0.0f}, {0.7660444378852844f, -0.6427876353263855f},
    {0.1736481785774231f, -0.9848077297210693f}, {-0.5f, -0.8660253882408142f},
    {-0.9396926164627075f, -0.3420201539993286f},
    {-0.9396926164627075f, 0.3420201539993286f}, {-0.5f, 0.8660253882408142f},
    {0.1736481785774231f, 0.9848077297210693f},
    {0.7660444378852844f, 0.6427876353263855f}};
static __constant__ float2 c_band_w25[25] = {
    {1.0f, 0.0f}, {0.9685831665992737f, -0.24868988990783691f},
    {0.8763066530227661f, -0.4817536771297455f},
    {0.728968620300293f, -0.6845471262931824f},
    {0.5358268022537231f, -0.8443279266357422f},
    {0.30901700258255005f, -0.9510565400123596f},
    {0.06279052048921585f, -0.9980267286300659f},
    {-0.187381312251091f, -0.9822872281074524f},
    {-0.4257792830467224f, -0.9048270583152771f},
    {-0.6374239921569824f, -0.7705132365226746f},
    {-0.80901700258255f, -0.5877852439880371f},
    {-0.9297764897346497f, -0.3681245446205139f},
    {-0.9921147227287292f, -0.12533323466777802f},
    {-0.9921147227287292f, 0.12533323466777802f},
    {-0.9297764897346497f, 0.3681245446205139f},
    {-0.80901700258255f, 0.5877852439880371f},
    {-0.6374239921569824f, 0.7705132365226746f},
    {-0.4257792830467224f, 0.9048270583152771f},
    {-0.187381312251091f, 0.9822872281074524f},
    {0.06279052048921585f, 0.9980267286300659f},
    {0.30901700258255005f, 0.9510565400123596f},
    {0.5358268022537231f, 0.8443279266357422f},
    {0.728968620300293f, 0.6845471262931824f},
    {0.8763066530227661f, 0.4817536771297455f},
    {0.9685831665992737f, 0.24868988990783691f}};

template <int R>
__device__ __forceinline__ void band_dft(float2 (&x)[R]);

// Forward 3-point DFT.
__device__ __forceinline__ void band_dft3(float2 (&x)[3]) {
  constexpr float k = 0.866025403784438647f;
  const float2 s = cadd(x[1], x[2]), d = csub(x[1], x[2]);
  const float2 t = make_float2(x[0].x - 0.5f * s.x, x[0].y - 0.5f * s.y);
  x[0] = cadd(x[0], s);
  x[1] = make_float2(t.x + k * d.y, t.y - k * d.x);
  x[2] = make_float2(t.x - k * d.y, t.y + k * d.x);
}

// Forward 5-point DFT: X1 = a1 - i*b1, X4 = a1 + i*b1, X2 = a2 - i*b2,
// X3 = a2 + i*b2.
__device__ __forceinline__ void band_dft5(float2 (&x)[5]) {
  constexpr float c1 = 0.309016994374947424f, c2 = -0.809016994374947424f;
  constexpr float s1 = 0.951056516295153572f, s2 = 0.587785252292473129f;
  const float2 t1 = cadd(x[1], x[4]), t2 = cadd(x[2], x[3]);
  const float2 t3 = csub(x[1], x[4]), t4 = csub(x[2], x[3]);
  const float2 a1 = make_float2(x[0].x + c1 * t1.x + c2 * t2.x,
                                x[0].y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(x[0].x + c2 * t1.x + c1 * t2.x,
                                x[0].y + c2 * t1.y + c1 * t2.y);
  const float2 b1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
  const float2 b2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
  x[0] = make_float2(x[0].x + t1.x + t2.x, x[0].y + t1.y + t2.y);
  x[1] = make_float2(a1.x + b1.y, a1.y - b1.x);
  x[4] = make_float2(a1.x - b1.y, a1.y + b1.x);
  x[2] = make_float2(a2.x + b2.y, a2.y - b2.x);
  x[3] = make_float2(a2.x - b2.y, a2.y + b2.x);
}

template <int R>
__device__ __forceinline__ float2 band_wconst(int m) {
  if constexpr (R == 9) {
    return c_band_w9[m];
  } else {
    static_assert(R == 25, "constant twiddles exist for radix 9 and 25");
    return c_band_w25[m];
  }
}

// Forward DFT of R = R1*R2 points in registers (Cooley-Tukey):
// x[R2*n1 + n2] -> X[k1 + R1*k2]; every index a constant after unrolling.
template <int R1, int R2>
__device__ __forceinline__ void band_dft_ct(float2 (&x)[R1 * R2]) {
  float2 y[R1 * R2];
#pragma unroll
  for (int n2 = 0; n2 < R2; ++n2) {
    float2 t[R1];
#pragma unroll
    for (int n1 = 0; n1 < R1; ++n1) t[n1] = x[R2 * n1 + n2];
    band_dft<R1>(t);
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      y[n2 * R1 + k1] = (n2 * k1 == 0)
                            ? t[k1]
                            : cmul(t[k1], band_wconst<R1 * R2>(n2 * k1));
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < R1; ++k1) {
    float2 t[R2];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) t[n2] = y[n2 * R1 + k1];
    band_dft<R2>(t);
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) x[k1 + R1 * k2] = t[k2];
  }
}

template <int R>
__device__ __forceinline__ void band_dft(float2 (&x)[R]) {
  if constexpr (R == 3) {
    band_dft3(x);
  } else if constexpr (R == 5) {
    band_dft5(x);
  } else if constexpr (R == 9) {
    band_dft_ct<3, 3>(x);
  } else if constexpr (R == 25) {
    band_dft_ct<5, 5>(x);
  } else {
    dft<R>(x, -1.0f);   // 2, 4, 8, 16 (fft_common.cuh)
  }
}

__device__ __forceinline__ void band_cp_async16(float2* dst,
                                                const float2* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;"
               :
               : "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void band_cp_async8(float2* dst,
                                               const float2* src) {
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 8;"
               :
               : "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void band_cp_async_commit() {
  asm volatile("cp.async.commit_group;" : : : "memory");
}

__device__ __forceinline__ void band_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" : : : "memory");
}

// Where a unit's results go, per thread (sequence w of the unit).
struct BandDest {
  float2* base;       // column: the unit's tile in the scratch; row: out + row
  const float2* u;    // column: U[j2 >> 5] + 0 (indexed by k1)
  const float2* v;    // column: V[j2 & 31]
  int w4;             // column: 4 * w
  bool valid;         // the column j2 or the row k1 exists (the last unit
                      // of a pass may be ragged)
};

// Unit `unit`'s tile into `tile` (4 sequences of L points; point j of
// sequence w at j*4 + w), by cp.async.
// Part `part` of `parts`: every parts-th round of kBandThreads pieces, so
// that a unit's loads can go out between the stages of the unit before.
template <bool ROW>
__device__ __forceinline__ void band_load(float2* tile,
                                          const float2* __restrict__ in,
                                          const BandPass& d, int unit,
                                          int part, int parts) {
  const int band = unit / d.units;
  const int idx = unit - band * d.units;
  if (!ROW) {
    // Columns 4*idx .. +3, of which `cols` exist: 32 B at x[j*b + 4*idx],
    // on a 16-byte boundary or 8 bytes off it. Piece p is columns 2h,
    // 2h + 1 (h = p & 1) of row j = p >> 1.
    const float2* src = in + band * d.n + 4 * idx;
    const int cols = min(kBandW, d.b - 4 * idx);
    for (int p = threadIdx.x + part * kBandThreads; p < 2 * d.L;
         p += parts * kBandThreads) {
      const int h = (p & 1) * 2;
      float2* to = tile + 2 * p;
      const float2* from = src + (p >> 1) * d.b + h;
      if (h + 2 <= cols && (reinterpret_cast<uintptr_t>(from) & 15) == 0) {
        band_cp_async16(to, from);
      } else {
        if (h < cols) band_cp_async8(to, from);
        if (h + 1 < cols) band_cp_async8(to + 1, from + 1);
      }
    }
  } else {
    // Rows 4*idx .. +3: one contiguous run of the scratch, in its order
    // (tile of columns, column, row). Piece p is rows 2h, 2h + 1 (h =
    // p & 1) of column j = 4*(p >> 3) + ((p & 7) >> 1).
    const float2* src = in + band * d.ss + (idx / kBandGroups) * d.gs +
                        (idx % kBandGroups) * 16;
    const int pieces = 8 * d.tiles;
    for (int p = threadIdx.x + part * kBandThreads; p < pieces;
         p += parts * kBandThreads) {
      const int j = 4 * (p >> 3) + ((p & 7) >> 1);
      if (j < d.L) {
        float2* to = tile + j * kBandW + (p & 1) * 2;
        const float2* from = src + (p >> 3) * (16 * kBandGroups) + 2 * (p & 7);
        band_cp_async16(to, from);
      }
    }
  }
}

// The last stage's store of output q of butterfly bf: point k = bf + q*Ns
// of the transform (Ns*R = L). Column pass: T[k1, j2] times the outer
// twiddle w, at row group k1/4, the unit's tile, column w, row k1 mod 4;
// row pass: X[k1 + a*k2], conjugated for the backward sign.
template <bool ROW>
__device__ __forceinline__ void band_put(const BandPass& d, const BandDest& o,
                                         int k, float2 v, float2 tw) {
  if (!ROW) {
    if (o.valid) {
      o.base[(k >> 5) * (int)d.gs + ((k >> 2) & 7) * 16 + o.w4 + (k & 3)] =
          cmul(v, tw);
    }
  } else if (o.valid) {
    if (d.conj) v.y = -v.y;
    o.base[d.a * k] = v;
  }
}

// W_n^(k*j2) for the thread's column j2, k < a (U and V).
__device__ __forceinline__ float2 band_outer(const BandDest& o, int k) {
  return cmul(__ldg(o.u + k), __ldg(o.v + k));
}

// The outputs of one last-stage butterfly. The column pass's outer
// twiddle of output q is base * S[q], base = W_n^(bf*j2) and S[q] =
// W_n^(q*Ns*j2) (band_steps), or, for R = 25, from U and V again.
template <int R, bool ROW>
__device__ __forceinline__ void band_store(const BandPass& d,
                                           const BandDest& o,
                                           const float2 (&x)[R],
                                           const float2* S, int bf, int Ns,
                                           float2 base) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int k = bf + q * Ns;
    float2 tw = base;
    if (!ROW && q > 0) {
      if constexpr (R <= 16) {
        tw = cmul(base, S[q]);
      } else {
        tw = band_outer(o, k);
      }
    }
    band_put<ROW>(d, o, k, x[q], tw);
  }
}

// S[q] = W_n^(q*Ns*j2), 0 < q < R, for the column pass's last stage.
template <int R>
__device__ __forceinline__ void band_steps(float2 (&S)[R <= 16 ? R : 1],
                                           const BandDest& o, int Ns) {
  if constexpr (R <= 16) {
#pragma unroll
    for (int q = 1; q < R; ++q) S[q] = band_outer(o, q * Ns);
  }
}

// The first stage (Ns = 1) of a chain over L points: butterfly bf takes
// points j0 + q*L/R of the tile as loaded (j0 = first[bf]: the points that
// the in-place chain would find at bf*R + q after a digit-reversed load),
// every butterfly of the thread into registers, then, after a barrier, the
// outputs to bf*R + q. The chain's later stages run in place. `j0t` is
// first[bf_of(t)]; bf_of(i) is the i-th first-stage butterfly of a thread
// (band_first_bf).
template <int R, int L, typename B>
__device__ __forceinline__ void band_first(float2* tile,
                                           const int* __restrict__ first,
                                           int t, int w, int j0t,
                                           bool conj_in, B bf_of) {
  constexpr int NB = (L / R + kBandT - 1) / kBandT;
  constexpr int nb = L / R;
  float2 u[NB * R];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int bf = bf_of(t + i * kBandT);
    if (bf < nb) {
      const int j0 = i == 0 ? j0t : __ldg(first + bf);
      float2 x[R];
      const float2* at = tile + j0 * kBandW + w;
#pragma unroll
      for (int q = 0; q < R; ++q) x[q] = at[q * nb * kBandW];
      if (conj_in) {
#pragma unroll
        for (int q = 0; q < R; ++q) x[q].y = -x[q].y;
      }
      band_dft<R>(x);
#pragma unroll
      for (int q = 0; q < R; ++q) u[i * R + q] = x[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int bf = bf_of(t + i * kBandT);
    if (bf < nb) {
      float2* at = tile + bf * R * kBandW + w;
#pragma unroll
      for (int q = 0; q < R; ++q) at[q * kBandW] = u[i * R + q];
    }
  }
  __syncthreads();
}

// A later radix-R stage of the 4 sequences in `tile`, in place: butterfly
// bf = (group, bm), bm = bf mod Ns, reads points base + q*Ns with base =
// (bf - bm)*R + bm (q < R), twiddles them by W_{Ns*R}^(q*bm), and writes
// output q back to point base + q*Ns. Thread (t, w) takes butterflies
// t, t + kBandT, ... of sequence w, one at a time. The last stage (Ns*R =
// L, base = bf) stores to device memory instead: output q of butterfly bf
// is point bf + q*Ns of the transform, in natural order. L is the
// sequence's length, Ns the product of the radices before this stage and
// TW the offset of its twiddles ([q-1][bm]) in the pass's.
template <int R, bool ROW, bool LAST, int L, int Ns, int TW>
__device__ __forceinline__ void band_stage(float2* tile, const float2* stw,
                                           const BandPass& d,
                                           const BandDest& o, int t, int w) {
  constexpr int nb = L / R;
  // The column pass's last stage: the outer twiddle's steps, and its base
  // W_n^(bf*j2), bf = t, t + kBandT, ..., by a product a round.
  float2 S[LAST && R <= 16 ? R : 1];
  float2 base = make_float2(1.f, 0.f), roll = base;
  if constexpr (LAST && !ROW) {
    band_steps<R>(S, o, Ns);
    if (t < nb) base = band_outer(o, t);
    if (kBandT < d.a) roll = band_outer(o, kBandT);
  }
#pragma unroll (R <= 8 ? 2 : 1)
  for (int bf = t; bf < nb; bf += kBandT) {
    const int bm = bf % Ns;
    float2* at = tile + ((bf - bm) * R + bm) * kBandW + w;
    float2 x[R];
#pragma unroll
    for (int q = 0; q < R; ++q) x[q] = at[q * Ns * kBandW];
    const float2* tw = stw + TW + bm;
#pragma unroll
    for (int q = 1; q < R; ++q) x[q] = cmul(x[q], tw[(q - 1) * Ns]);
    band_dft<R>(x);
    if constexpr (!LAST) {
#pragma unroll
      for (int q = 0; q < R; ++q) at[q * Ns * kBandW] = x[q];
    } else {
      band_store<R, ROW>(d, o, x, S, bf, Ns, base);
      if constexpr (!ROW) base = cmul(base, roll);
    }
  }
  if constexpr (!LAST) __syncthreads();
}

template <bool ROW>
__device__ __forceinline__ BandDest band_dest(float2* __restrict__ out,
                                              const float2* __restrict__ tab,
                                              const BandPass& d, int unit,
                                              int w) {
  const int band = unit / d.units;
  const int idx = unit - band * d.units;
  BandDest o;
  if (!ROW) {
    const int j2 = 4 * idx + w;
    o.base = out + band * d.ss + 16 * kBandGroups * idx;
    o.u = tab + d.u_off + (long long)(j2 >> kBandUBits) * d.a;
    o.v = tab + d.v_off + (long long)(j2 & ((1 << kBandUBits) - 1)) * d.a;
    o.w4 = 4 * w;
    o.valid = j2 < d.b;
  } else {
    const int row = 4 * idx + w;
    o.base = out + band * d.n + row;
    o.u = o.v = nullptr;
    o.w4 = 0;
    o.valid = row < d.a;
  }
  return o;
}

// The first-stage butterfly of thread t in a chain of three stages: the
// identity, but for R1*R2 = 16*8 = kBandT and R0 = 1 mod 4 (3200 =
// 25*16*8) a permutation under which the four threads of a quarter warp
// read (points j0 + q*L/R0, j0 = 8*(bf mod 16) + bf/16) and write (points
// bf*R0 + q) in distinct banks; with bf = t the reads fell in one.
template <int R0, int R1, int R2>
__device__ __forceinline__ int band_first_bf(int t) {
  if constexpr (R1 == 16 && R2 == 8 && R0 % 4 == 1) {
    const int k = t >> 2, m = t & 3;
    const int hi = m + 4 * (k & 1);
    const int lo = 4 * ((k >> 1) & 3) + ((m + (k >> 3)) & 3);
    return 16 * hi + lo;
  } else {
    return t;
  }
}

// One unit's chain of three stages, L = R0*R1*R2, with every offset and
// bound a constant. issue(part, 3) sends part of the next unit's loads
// ahead of each stage.
template <bool ROW, int L, int R0, int R1, int R2, typename Issue>
__device__ __forceinline__ void band_chain(float2* tile,
                                           const int* __restrict__ first,
                                           const float2* stw,
                                           const BandPass& d,
                                           const BandDest& o, int t, int w,
                                           int j0t, Issue&& issue) {
  static_assert(L == R0 * R1 * R2, "a chain's radices multiply to L");
  issue(0, 3);
  auto bf_of = [](int bf) { return band_first_bf<R0, R1, R2>(bf); };
  band_first<R0, L>(tile, first, t, w, j0t, !ROW && d.conj, bf_of);
  issue(1, 3);
  band_stage<R1, ROW, false, L, R0, R0 - 1>(tile, stw, d, o, t, w);
  issue(2, 3);
  band_stage<R2, ROW, true, L, R0 * R1, (R0 - 1) + (R1 - 1) * R0>(
      tile, stw, d, o, t, w);
}

// One pass over the whole batch: ROW false is the column pass (x ->
// scratch), true the row pass (scratch -> X), its chain
// band_chain<ROW, L, R0, R1, R2>.
template <bool ROW, int L, int R0, int R1, int R2>
__global__ void __launch_bounds__(kBandThreads, 1)
    band_pass_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                     const float2* __restrict__ tab,
                     const int* __restrict__ first, BandPass d) {
  extern __shared__ float4 band_smem_tiles[];
  float2* const tile0 = reinterpret_cast<float2*>(band_smem_tiles);
  float2* const tile1 = tile0 + kBandW * L;
  float2* const stw = tile1 + kBandW * L;
  for (int e = threadIdx.x; e < L - 1; e += kBandThreads) {
    stw[e] = __ldg(tab + d.tw0 + e);
  }
  const int w = threadIdx.x & (kBandW - 1);
  const int t = threadIdx.x >> 2;
  int unit = blockIdx.x;
  int j0t = 0;
  if (t < L / R0) j0t = __ldg(first + band_first_bf<R0, R1, R2>(t));
  band_load<ROW>(tile0, in, d, unit, 0, 1);
  band_cp_async_commit();
  for (int k = 0;; ++k) {
    float2* const cur = (k & 1) ? tile1 : tile0;
    float2* const nxt = (k & 1) ? tile0 : tile1;
    const int next = unit + (int)gridDim.x;
    const bool more = next < d.total;
    // This unit's tile is in; the unit before read `nxt` last; the stage
    // twiddles are in.
    band_cp_async_wait_all();
    __syncthreads();
    const BandDest o = band_dest<ROW>(out, tab, d, unit, w);
    auto issue = [&](int part, int parts) {
      if (more) band_load<ROW>(nxt, in, d, next, part, parts);
    };
    band_chain<ROW, L, R0, R1, R2>(cur, first, stw, d, o, t, w, j0t,
                                   issue);
    band_cp_async_commit();
    if (!more) break;
    unit = next;
  }
}

template <typename Kernel>
static int band_enqueue(Kernel kernel, const float2* in, float2* out,
                        const float2* tab, const int* first,
                        const BandPass& d, cudaStream_t stream) {
  const size_t smem = sizeof(float2) * (2 * kBandW * (size_t)d.L + d.L - 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kBandThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = d.total < sms * per_sm ? d.total : sms * per_sm;
  kernel<<<grid, kBandThreads, smem, stream>>>(in, out, tab, first, d);
  return (int)cudaGetLastError();
}

// The pass's kernel: the chain of its side, 3200 = 25*16*8 or 3125 =
// 25*25*5.
template <bool ROW>
static int band_launch(const float2* in, float2* out, const float2* tab,
                       const int* first, const BandPass& d,
                       cudaStream_t stream) {
  if (d.L == 3200) {
    return band_enqueue(band_pass_kernel<ROW, 3200, 25, 16, 8>, in, out,
                        tab, first, d, stream);
  }
  return band_enqueue(band_pass_kernel<ROW, 3125, 25, 25, 5>, in, out, tab,
                      first, d, stream);
}

}  // namespace rc

// The transform of `batch` rows of n = a*b complex64 points: x -> y, both
// (batch, n), through `scratch` (batch * ceil(a/4) * 16 * ceil(b/4)
// points: row group, tile of columns, column, row). a = 3200; b = 3200 or
// 3125. `table` is kernels/fft_band.py band_table(a, b): the column pass's
// stage twiddles (a - 1), the row pass's (b - 1), U (ceil(b/32) rows of a)
// and V (32 rows of a); `first` is its first_points of a, then of b
// (int32: a/25 and b/25 entries). x is never written.
extern "C" int rc_fft_band(const void* x, void* scratch, void* y,
                           long long batch, int a, int b, int sign,
                           const void* table, const void* first,
                           void* stream) {
  using namespace rc;
  if (!x || !scratch || !y || !table || !first || batch < 1 || a != 3200 ||
      (b != 3200 && b != 3125)) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)x | (uintptr_t)scratch | (uintptr_t)y) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  BandPass col, row;
  col.L = a;
  col.tw0 = 0;
  row.L = b;
  row.tw0 = a - 1;
  const long long tw = (long long)(a - 1) + (b - 1);
  const long long tiles = (b + 3) / 4, groups = (a + 3) / 4;
  const long long units_col = batch * tiles, units_row = batch * groups;
  if (units_col > 0x7fffffffLL || units_row > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  for (BandPass* d : {&col, &row}) {
    d->a = a;
    d->b = b;
    d->n = (long long)a * b;
    d->tiles = (int)tiles;
    d->gs = kBandGroups * 16 * tiles;
    d->ss = (groups + kBandGroups - 1) / kBandGroups * d->gs;
    d->u_off = tw;
    d->v_off = tw + (((long long)b + 31) >> kBandUBits) * a;
    d->conj = sign > 0;
  }
  col.units = (int)tiles;
  col.total = (int)units_col;
  row.units = (int)groups;
  row.total = (int)units_row;
  const cudaStream_t s = (cudaStream_t)stream;
  const float2* tab = (const float2*)table;
  const int err = band_launch<false>((const float2*)x, (float2*)scratch,
                                     tab, (const int*)first, col, s);
  if (err) return err;
  return band_launch<true>((const float2*)scratch, (float2*)y, tab,
                           (const int*)first + a / kBandR0, row, s);
}
