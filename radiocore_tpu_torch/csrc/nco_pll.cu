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
// by the time h is.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, 1980 MHz; rc_nco_chain_probe)
// the bare recurrence takes 22.3 cycles a sample as ptxas schedules it.
// When one warp also issued the pilot's two products, the output, the
// loads and stores and the tile's register copies (the one-warp form of
// this kernel), it took 26.9-27.8; this one takes 24.5-25.9 at
// 24 x 240 000.
//
// What the design does about it: a block is a warp-specialised pipeline.
//  - Warp 0 is the chain warp: lane l owns row l of the block and issues
//    the recurrence alone: psi and f, u's four, the series' five and the
//    max of |psi| a sample, one 16-byte shared load of two samples' (a, b)
//    (the next pair's issued before this pair is worked) and one 16-byte
//    shared store of the w the two samples saw. The stored w are copies (a
//    product by `one`, 1 from the host, exact for every value): ptxas
//    otherwise gives the store the chain's own registers and the chain's
//    next write waits until the store has read them (34.7 cycles a
//    sample). Warps 1..kNcoHelpers are helpers; the SM's four schedulers
//    take warps by index, so a helper issues on a scheduler of its own
//    and takes no slot from the chain warp (the probe's chain lane reads
//    the same with three busy warps beside it).
//  - A ring of kNcoRing tiles a row in shared memory, each slot holding a
//    tile's (a, b) and the w of each of its samples. The helpers stage a
//    tile, their threads sharing its quads over the block's rows: the raw
//    pilot comes in by cp.async (16-byte copies where every row is on a
//    16-byte boundary, 4-byte ones else) kNcoAhead tiles ahead into a ring
//    of raw tiles, and each thread writes a = as x and b = bs x (as the
//    kernel always rounded them) for the quads it copied. Once the chain
//    lanes have worked a tile, the helpers read its w back and write the
//    output (-Re w Im w, or nco_phase) by streaming stores.
//  - The two sides hand slots over through two mbarriers a slot: `full`
//    (every helper thread arrives once it has written the slot) and
//    `done` (every chain lane arrives once it has worked the tile). A
//    chain lane asks whether its next tile is staged before it works the
//    current one and reads the answer after, so the question's latency is
//    off the chain; a tile not staged when it is needed, past the row's
//    first, is counted on `starved` (one atomic add a chain lane) before
//    the lane waits: a positive count says the helpers set the pace.
//  - The series is checked a tile at a time, off the chain: each sample
//    folds |psi| into a running max, and a tile whose max passed
//    kNcoPsiMax (a wide loop, a pilot with spikes, an acquisition far off
//    19 kHz) is done again from its first state with the exact rotation
//    (sincosf), out of line (phasor_redo), from the (a, b) the slot still
//    holds, and counted on `redone` (one atomic add a redone tile), so
//    that a graph's replays count too. |w| drifts by the rounding of each
//    rotation (about 1e-7 a sample) and is brought back to sqrt(2) once a
//    tile by one Newton step, g = 1.5 - |w|^2 / 4. A tile is 80 samples
//    (kNcoPhasorTile); only the ragged end (under a tile) goes through the
//    ring sample by sample, each on the series or sincosf by its own |psi|.
//  - The block's rows: the caller gives `lanes`, rows a block and the
//    chain warp's lanes (kernels/nco_pll.py nco_geometry: one block an SM
//    while the rows allow, since a warp issues once for all its lanes);
//    every block has kNcoHelpers helper warps, as many as the other three
//    schedulers take. Shared memory is 6 432 bytes a row, 201 KB at 32.
//    From about four rows an SM the helpers' share of the work grows with
//    the rows while the chain's does not, and past 32 rows an SM they set
//    the pace.
//  - The state crosses chunks as the phase: w = sqrt(2) e^{j phase_in} by
//    sincosf at the start, phase_out = atan2f(Im w, Re w) at the end, in
//    (-pi, pi] as the scan's wrapped phase is.
//
// Every product and sum of a sample is the one-warp kernel's, so both
// outputs and the final state equal it bit for bit; the design moves
// instructions between warps. The kernel does not round as the scan does:
// the scan carries the phase in float32 and rounds it at every sum, the
// kernel carries w. On the CPU, over rms-normalised pilots, the scan's
// float32 trajectory drifts up to about 1e-4 rad from a float64 loop while
// it acquires, the phasor's plain loop a few 1e-6.
// kernels/nco_pll.py `nco_pll_phasor_plain` is the kernel's arithmetic in
// float32 with the rows as the vector.
#include <cuda_runtime.h>

#include <cstdint>

namespace rc {

constexpr int kNcoThreads = 32;    // a warp; chain lanes a block, at most
constexpr int kNcoHelpers = 3;     // helper warps a block
// The series limit: (1 - psi^2 / 2, psi) is e^{jpsi} to within 2^-26 for
// |psi| <= 2^-8.
constexpr float kNcoPsiMax = 0.00390625f;
constexpr int kNcoPhasorTile = 80;  // samples a tile
constexpr int kNcoRing = 4;         // tiles a row in the (a, b) / w ring
constexpr int kNcoAhead = 3;        // tiles of raw pilot in flight a row
static_assert(kNcoPhasorTile % 4 == 0, "a tile is whole quads");

// What a sample writes (the C entry's `output`).
constexpr int kNcoSubcarrier = 0;  // -sin 2p = -Re w Im w
constexpr int kNcoPhase = 1;       // p = atan2(Im w, Re w), nco_phase

// The block's shared memory a row, in float4s: the ring's (a, b) and its
// w, two samples a float4, each with one float4 of padding so that the
// chain lanes' 16-byte accesses fall on distinct banks; the raw pilot, a
// quad a float4.
constexpr int kNcoSlot = kNcoPhasorTile / 2;
constexpr int kNcoRingStride = kNcoRing * kNcoSlot + 1;
constexpr int kNcoRawTiles = kNcoAhead + 1;
constexpr int kNcoRawStride = kNcoRawTiles * kNcoPhasorTile / 4;

inline long long nco_smem_bytes(int lanes) {
  return 2LL * kNcoRing * 8 +                   // full, done
         (lanes + 1LL) / 2 * 16 +               // (as, bs) a row
         16LL * lanes * (2 * kNcoRingStride + kNcoRawStride);
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
  unsigned long long* redone;   // tiles done again with sincosf
  unsigned long long* starved;  // tiles a chain lane found not yet staged
  long long rows;
  long long n;
  int lanes;     // rows a block: the chain warp's lanes
  bool vec_x;    // every row of x on a 16-byte boundary
  bool vec_out;  // every row of out on a 16-byte boundary
  float ak, ai;  // (ki + kp) / sqrt(2) and ki / sqrt(2), float32
  float cw, sw;  // e^{j w0}
  float one;     // 1: the chain lane's copies of w
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

template <int kOut>
__device__ __forceinline__ float nco_out(float wr, float wi) {
  return kOut == kNcoSubcarrier ? __fmul_rn(-wr, wi) : nco_phase(wr, wi);
}

// One sample's turn of (w, f) from the pilot's two products a = as x and
// b = bs x (as = ak s_row, bs = ai s_row): the chain. The operands of each
// product stand in the order that gave ptxas its best schedule of the
// chain lane's tile (a product's value does not depend on it).
template <int kMode>
__device__ __forceinline__ void phasor_step(float a, float b, float& wr,
                                            float& wi, float& f, float cw,
                                            float sw, float& m) {
  const float psi = __fmaf_rn(wr, a, f);
  f = __fmaf_rn(wr, b, f);
  const float ur = __fmaf_rn(cw, wr, __fmul_rn(sw, -wi));
  const float ui = __fmaf_rn(sw, wr, __fmul_rn(cw, wi));
  if (kMode == kPhasorExact ||
      (kMode == kPhasorEither && fabsf(psi) > kNcoPsiMax)) {
    float c, s;
    sincosf(psi, &s, &c);
    wr = __fmaf_rn(ur, c, __fmul_rn(-ui, s));
    wi = __fmaf_rn(ui, c, __fmul_rn(ur, s));
  } else {
    if (kMode == kPhasorSeries) m = fmaxf(m, fabsf(psi));
    const float h = __fmul_rn(psi, 0.5f);
    const float qr = __fmaf_rn(ur, h, ui);
    const float qi = __fmaf_rn(ui, -h, ur);
    wr = __fmaf_rn(qr, -psi, ur);
    wi = __fmaf_rn(qi, psi, ui);
  }
}

// One sample with x and the output in registers (the probe's chains 0, 1).
template <int kMode, int kOut>
__device__ __forceinline__ float phasor_sample(float x, float& wr, float& wi,
                                               float& f, float as, float bs,
                                               float cw, float sw, float& m) {
  const float out = nco_out<kOut>(wr, wi);
  phasor_step<kMode>(__fmul_rn(as, x), __fmul_rn(bs, x), wr, wi, f, cw, sw,
                     m);
  return out;
}

// The chain lane's tile: (a0, b0, a1, b1) by one 16-byte shared load
// every two samples (the next pair's issued before this pair is worked),
// and the w the two samples saw, copied by a product by `one`, by one
// 16-byte shared store.
template <int kMode>
__device__ __forceinline__ void chain_tile(const float4* ab, float4* wq,
                                           float& wr, float& wi, float& f,
                                           float cw, float sw, float& m,
                                           float one) {
  float4 next = ab[0];
#pragma unroll
  for (int q = 0; q < kNcoSlot; ++q) {
    const float4 v = next;
    if (q + 1 < kNcoSlot) next = ab[q + 1];
    float4 o;
    o.x = __fmul_rn(wr, one);
    o.y = __fmul_rn(wi, one);
    phasor_step<kMode>(v.x, v.y, wr, wi, f, cw, sw, m);
    o.z = __fmul_rn(wr, one);
    o.w = __fmul_rn(wi, one);
    phasor_step<kMode>(v.z, v.w, wr, wi, f, cw, sw, m);
    wq[q] = o;
  }
}

struct PhasorState {
  float wr, wi, f;
};

// A tile again from `st` with the exact rotation, from the slot's (a, b),
// its w written again: out of line, so that the fast path's code stays in
// one piece.
__device__ __noinline__ PhasorState phasor_redo(const float4* ab, float4* wq,
                                                PhasorState st, float cw,
                                                float sw) {
  float m = 0.0f;
  for (int q = 0; q < kNcoSlot; ++q) {
    const float4 v = ab[q];
    float4 o;
    o.x = st.wr;
    o.y = st.wi;
    phasor_step<kPhasorExact>(v.x, v.y, st.wr, st.wi, st.f, cw, sw, m);
    o.z = st.wr;
    o.w = st.wi;
    phasor_step<kPhasorExact>(v.z, v.w, st.wr, st.wi, st.f, cw, sw, m);
    wq[q] = o;
  }
  return st;
}

// |w| back to sqrt(2): one Newton step of 1 / |w|, once a tile.
__device__ __forceinline__ void phasor_renorm(float& wr, float& wi) {
  const float g =
      __fmaf_rn(__fmaf_rn(wr, wr, __fmul_rn(wi, wi)), -0.25f, 1.5f);
  wr = __fmul_rn(wr, g);
  wi = __fmul_rn(wi, g);
}

// mbarriers in shared memory, by address, and cp.async (PTX; sm_90).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned at, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :
               : "r"(at), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned at) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :
               : "r"(at)
               : "memory");
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(unsigned at, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(at), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned at, unsigned parity) {
  unsigned ok;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(at), "r"(parity)
        : "memory");
  } while (ok == 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :
               : "r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :
               : "r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" : : : "memory");
}

// Until at most kNcoAhead - 1 of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;" : : "n"(kNcoAhead - 1) : "memory");
}

// The block's shared memory (nco_smem_bytes).
struct NcoShared {
  unsigned long long* full;  // kNcoRing: a slot staged
  unsigned long long* done;  // kNcoRing: a slot's tile worked
  float2* rowc;              // (as, bs) a row
  float4* ring;              // rows x kNcoRingStride: (a, b) a sample
  float4* wring;             // rows x kNcoRingStride: w a sample
  float4* raw;               // rows x kNcoRawStride: the pilot
};

__device__ __forceinline__ NcoShared nco_shared(int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  NcoShared sh;
  sh.full = reinterpret_cast<unsigned long long*>(smem);
  sh.done = sh.full + kNcoRing;
  sh.rowc = reinterpret_cast<float2*>(sh.done + kNcoRing);
  // (as, bs) take lanes x 8 bytes; the rings start on 16 bytes after them.
  sh.ring = reinterpret_cast<float4*>(sh.rowc + (lanes + 1) / 2 * 2);
  sh.wring = sh.ring + lanes * kNcoRingStride;
  sh.raw = sh.wring + lanes * kNcoRingStride;
  return sh;
}

// Samples of tile `i` of a row of n.
__device__ __forceinline__ int tile_count(long long i, long long n) {
  const long long left = n - i * kNcoPhasorTile;
  return (int)(left < kNcoPhasorTile ? left : kNcoPhasorTile);
}

// The helpers' work on a tile is spread over all their threads, a quad of
// samples of a row at a time, item k being quad k % kNcoQuads of block row
// k / kNcoQuads whatever the tile (a ragged tile's missing quads are
// skipped); `ht` is the thread's index among the helpers' kNcoThreads x
// kNcoHelpers. A quad moves by one 16-byte access where the tile is whole
// and every row of the tensor is on a 16-byte boundary, by one access a
// sample else. A thread stages the quads it fetched itself, so no thread
// waits on another's copies. Stages and writes take two items at a time,
// both loads before either store.
constexpr int kNcoQuads = kNcoPhasorTile / 4;

// Tile `i`'s raw pilot, by cp.async into raw tile `i % kNcoRawTiles`.
__device__ __forceinline__ void helper_fetch(const NcoShared& sh,
                                             const NcoPhasor& prm,
                                             long long row0, int rows_here,
                                             long long i, int ht, int hts) {
  const int count = tile_count(i, prm.n);
  const bool vec = prm.vec_x && count == kNcoPhasorTile;
  const int slot = (int)(i % kNcoRawTiles) * kNcoQuads;
  for (int k = ht; k < kNcoQuads * rows_here; k += hts) {
    const int r = k / kNcoQuads;
    const int q = k - r * kNcoQuads;
    if (4 * q >= count) continue;
    const float* src =
        prm.x + (row0 + r) * prm.x_stride + i * kNcoPhasorTile + 4 * q;
    float4* raw = sh.raw + r * kNcoRawStride + slot + q;
    if (vec) {
      cp_async16(raw, src);
    } else {
      for (int j = 0; j < 4 && 4 * q + j < count; ++j) {
        cp_async4(reinterpret_cast<float*>(raw) + j, src + j);
      }
    }
  }
}

// (a, b) = (as x, bs x) of a quad, rounded as the kernel always rounded
// them, as the two float4s of the ring.
__device__ __forceinline__ void quad_ab(float2 c, float4 x, float4* ab) {
  ab[0] = make_float4(__fmul_rn(c.x, x.x), __fmul_rn(c.y, x.x),
                      __fmul_rn(c.x, x.y), __fmul_rn(c.y, x.y));
  ab[1] = make_float4(__fmul_rn(c.x, x.z), __fmul_rn(c.y, x.z),
                      __fmul_rn(c.x, x.w), __fmul_rn(c.y, x.w));
}

// ... and its staging into ring slot `s`. Samples past a ragged row's end
// are staged too, from whatever the raw tile held, and never read.
__device__ __forceinline__ void helper_stage(const NcoShared& sh,
                                             int rows_here, int s,
                                             long long i, int ht, int hts) {
  const int slot = (int)(i % kNcoRawTiles) * kNcoQuads;
  const int items = kNcoQuads * rows_here;
  for (int k = ht; k < items; k += 2 * hts) {
    const int k2 = k + hts < items ? k + hts : k;
    const int r = k / kNcoQuads, q = k - r * kNcoQuads;
    const int r2 = k2 / kNcoQuads, q2 = k2 - r2 * kNcoQuads;
    const float4 x = sh.raw[r * kNcoRawStride + slot + q];
    const float4 x2 = sh.raw[r2 * kNcoRawStride + slot + q2];
    const float2 c = sh.rowc[r];
    const float2 c2 = sh.rowc[r2];
    quad_ab(c, x, sh.ring + r * kNcoRingStride + s * kNcoSlot + 2 * q);
    quad_ab(c2, x2, sh.ring + r2 * kNcoRingStride + s * kNcoSlot + 2 * q2);
  }
}

// The output of a quad of tile `i` of block row `r` from its w.
template <int kOut>
__device__ __forceinline__ void quad_write(const NcoPhasor& prm,
                                           long long row0, int r, int q,
                                           long long i, int count, bool vec,
                                           float4 u, float4 v) {
  if (4 * q >= count) return;
  float* dst = prm.out + (row0 + r) * prm.n + i * kNcoPhasorTile + 4 * q;
  float o[4] = {nco_out<kOut>(u.x, u.y), nco_out<kOut>(u.z, u.w),
                nco_out<kOut>(v.x, v.y), nco_out<kOut>(v.z, v.w)};
  // The phase's first sample is the phase given (the scan's), not the
  // rounded atan2 of its phasor.
  if (kOut == kNcoPhase && i == 0 && q == 0) o[0] = prm.phase_in[row0 + r];
  if (vec) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(o[0], o[1], o[2], o[3]));
  } else {
    for (int j = 0; j < 4 && 4 * q + j < count; ++j) __stcs(dst + j, o[j]);
  }
}

// The output of tile `i` from the w in slot `s`, by streaming stores.
template <int kOut>
__device__ __forceinline__ void helper_write(const NcoShared& sh,
                                             const NcoPhasor& prm,
                                             long long row0, int rows_here,
                                             int s, long long i, int ht,
                                             int hts) {
  const int count = tile_count(i, prm.n);
  const bool vec = prm.vec_out && count == kNcoPhasorTile;
  const int items = kNcoQuads * rows_here;
  for (int k = ht; k < items; k += 2 * hts) {
    const bool two = k + hts < items;
    const int k2 = two ? k + hts : k;
    const int r = k / kNcoQuads, q = k - r * kNcoQuads;
    const int r2 = k2 / kNcoQuads, q2 = k2 - r2 * kNcoQuads;
    const float4* wq = sh.wring + r * kNcoRingStride + s * kNcoSlot + 2 * q;
    const float4* wq2 =
        sh.wring + r2 * kNcoRingStride + s * kNcoSlot + 2 * q2;
    const float4 u = wq[0], v = wq[1];
    const float4 u2 = wq2[0], v2 = wq2[1];
    quad_write<kOut>(prm, row0, r, q, i, count, vec, u, v);
    if (two) quad_write<kOut>(prm, row0, r2, q2, i, count, vec, u2, v2);
  }
}

// The helper warps: for each tile, the output of the tile kNcoRing back,
// once the chain lanes are done with it, and the tile staged into the
// slot that frees; the raw pilot runs kNcoAhead tiles ahead of the
// staging.
template <int kOut>
__device__ __forceinline__ void nco_helper(const NcoShared& sh,
                                           const NcoPhasor& prm,
                                           long long row0, int rows_here,
                                           int ht) {
  const int hts = kNcoThreads * kNcoHelpers;
  const long long tiles = (prm.n + kNcoPhasorTile - 1) / kNcoPhasorTile;
  const unsigned full_at = smem_addr(sh.full);
  const unsigned done_at = smem_addr(sh.done);
  for (long long i = 0; i < kNcoAhead; ++i) {
    if (i < tiles) helper_fetch(sh, prm, row0, rows_here, i, ht, hts);
    cp_async_commit();
  }
  int s = 0;
  unsigned parity = 0;
  for (long long i = 0; i < tiles + kNcoRing; ++i) {
    if (i >= kNcoRing) {
      // Slot s's tile i - kNcoRing, once its chain lanes are done with it.
      mbar_wait(done_at + 8u * s, parity ^ 1u);
      helper_write<kOut>(sh, prm, row0, rows_here, s, i - kNcoRing, ht, hts);
    }
    if (i < tiles) {
      cp_async_wait_ahead();
      helper_stage(sh, rows_here, s, i, ht, hts);
      mbar_arrive(full_at + 8u * s);
      if (i + kNcoAhead < tiles) {
        helper_fetch(sh, prm, row0, rows_here, i + kNcoAhead, ht, hts);
      }
      cp_async_commit();
    }
    if (++s == kNcoRing) {
      s = 0;
      parity ^= 1u;
    }
  }
}

template <int kOut>
__global__ void __launch_bounds__(kNcoThreads * (1 + kNcoHelpers))
    nco_pll_kernel_phasor(const NcoPhasor prm) {
  const NcoShared sh = nco_shared(prm.lanes);
  const long long row0 = (long long)blockIdx.x * prm.lanes;
  const int rows_here = (int)(prm.rows - row0 < prm.lanes ? prm.rows - row0
                                                          : prm.lanes);
  const int warp = threadIdx.x / kNcoThreads;
  const int lane = threadIdx.x % kNcoThreads;
  const unsigned full_at = smem_addr(sh.full);
  const unsigned done_at = smem_addr(sh.done);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kNcoRing; ++s) {
      mbar_init(full_at + 8u * s, kNcoThreads * kNcoHelpers);
      mbar_init(done_at + 8u * s, rows_here);
    }
  }
  if (warp == 0 && lane < rows_here) {
    const float s_row = prm.scale[row0 + lane];
    sh.rowc[lane] =
        make_float2(__fmul_rn(prm.ak, s_row), __fmul_rn(prm.ai, s_row));
  }
  __syncthreads();
  if (warp > 0) {
    nco_helper<kOut>(sh, prm, row0, rows_here,
                     (int)threadIdx.x - kNcoThreads);
    return;
  }
  // The chain lane of row `lane`.
  if (lane >= rows_here) return;
  const long long row = row0 + lane;
  const long long n = prm.n;
  const float cw = prm.cw;
  const float sw = prm.sw;
  const float one = prm.one;
  float wr, wi;
  sincosf(prm.phase_in[row], &wi, &wr);
  wr = __fmul_rn(wr, 1.41421356237309504880f);
  wi = __fmul_rn(wi, 1.41421356237309504880f);
  float f = prm.freq_in[row];
  const float4* ring = sh.ring + lane * kNcoRingStride;
  float4* wring = sh.wring + lane * kNcoRingStride;
  const int whole = (int)(n / kNcoPhasorTile);
  const int rest = (int)(n - (long long)whole * kNcoPhasorTile);
  unsigned long long* const redone = prm.redone;
  unsigned long long* const starved = prm.starved;
  // Tile 0 is waited for without a count: the helpers start with it.
  mbar_wait(full_at, 0u);
  int s = 0;
  unsigned parity = 0;
  for (int i = 0; i < whole; ++i) {
    const int s1 = s + 1 == kNcoRing ? 0 : s + 1;
    const unsigned p1 = s1 == 0 ? parity ^ 1u : parity;
    // Whether the next tile is staged: asked before this tile is worked
    // and read after it, so that the question's latency is off the chain.
    const bool ready = (i + 1 == whole && rest == 0) ||
                       mbar_test(full_at + 8u * s1, p1);
    const float4* ab = ring + s * kNcoSlot;
    float4* wq = wring + s * kNcoSlot;
    const PhasorState st0{wr, wi, f};
    float m = 0.0f;
    chain_tile<kPhasorSeries>(ab, wq, wr, wi, f, cw, sw, m, one);
    if (m > kNcoPsiMax) {
      const PhasorState st = phasor_redo(ab, wq, st0, cw, sw);
      wr = st.wr;
      wi = st.wi;
      f = st.f;
      atomicAdd(redone, 1ULL);
    }
    phasor_renorm(wr, wi);
    mbar_arrive(done_at + 8u * s);
    if (!ready && !mbar_test(full_at + 8u * s1, p1)) {
      atomicAdd(starved, 1ULL);
      mbar_wait(full_at + 8u * s1, p1);
    }
    s = s1;
    parity = p1;
  }
  if (rest > 0) {
    // The ragged end, sample by sample (its slot waited for above).
    const float2* ab2 = reinterpret_cast<const float2*>(ring + s * kNcoSlot);
    float2* w2 = reinterpret_cast<float2*>(wring + s * kNcoSlot);
    float m = 0.0f;
    for (int j = 0; j < rest; ++j) {
      const float2 v = ab2[j];
      w2[j] = make_float2(wr, wi);
      phasor_step<kPhasorEither>(v.x, v.y, wr, wi, f, cw, sw, m);
    }
    mbar_arrive(done_at + 8u * s);
  }
  prm.phase_out[row] = atan2f(wi, wr);
  prm.freq_out[row] = f;
}

// The measuring aid behind rc_nco_chain_probe: each chain lane (the first
// `lanes` threads of warp 0) runs n links of a chain with x and the
// constants in registers, and writes its state and the SM cycles the loop
// took once at the end.
//   kChain 0: the bare recurrence, w' = (w e^{jw0}) e^{jpsi} with
//             psi = fma(a, Re w, f) and the series, and f's update
//   kChain 1: the kernel's tiles without memory: each sample's subcarrier
//             and the max of |psi| kept (an empty asm, no instruction) in
//             place of the stores and the guard's branch, and |w|'s
//             renormalisation, n / kNcoPhasorTile of them
//   kChain 2: the kernel's chain lane: tiles of (a, b) two samples at a
//             time from its slot in shared memory, the w each sample saw
//             stored back two at a time, the max of |psi| tested (the
//             tiles past the limit counted, not redone) and |w|
//             renormalised, n / kNcoPhasorTile of them
// (An empty asm keeps a value from the compiler but not from ptxas: chain
// 1 has neither its max nor its outputs, chain 2 has both.)
// The other warps of the block (`helpers` of them) are kept busy beside
// the chain lanes until these are done: each runs independent multiply-adds
// and shared-memory stores back to back, so that a helper on the chain
// warp's scheduler would take its issue slots.
constexpr int kProbeStride = kNcoPhasorTile / 2 + 1;  // float4s a lane
// The probe's slots are static shared memory, 48 KB at most: 32 lanes
// hold tiles of up to 88 samples.
static_assert(2 * kNcoThreads * kProbeStride * 16 <= 48 * 1024,
              "the probe's slots pass static shared memory");

template <int kChain>
__global__ void nco_chain_probe_kernel(float* result, long long* cycles,
                                       long long n, int lanes, float x,
                                       float kp, float ki, float w0,
                                       float one) {
  __shared__ float4 ring[2][kNcoThreads * kProbeStride];
  __shared__ int done;
  const int lane = threadIdx.x;
  if (lane == 0) done = 0;
  __syncthreads();
  if (lane >= kNcoThreads) {
    // A helper: four independent multiply-add chains and a store a round.
    float acc[4] = {x, 1.0f + x, 2.0f + x, 3.0f + x};
    float4* scratch = ring[1] + (lane % kNcoThreads) * kProbeStride;
    while (*(volatile int*)&done == 0) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(acc[j], 0.999f, 0.001f);
        scratch[k] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    if (acc[0] == 12345.0f) result[0] = acc[1];  // keeps the work
    return;
  }
  if (lane >= lanes) return;
  const float kk = __fadd_rn(ki, kp);
  float f = 0.0f;
  const long long t0 = clock64();
  const float as = __fmul_rn(kk, 0.70710678118654752440f);
  const float bs = __fmul_rn(ki, 0.70710678118654752440f);
  const float cw = cosf(w0);
  const float sw = sinf(w0);
  float wr, wi;
  sincosf(0.01f * lane, &wi, &wr);
  wr = __fmul_rn(wr, 1.41421356237309504880f);
  wi = __fmul_rn(wi, 1.41421356237309504880f);
  int far = 0;  // chain 2's tiles past the series' limit
  if (kChain == 0) {
    float m = 0.0f;
#pragma unroll 16
    for (long long i = 0; i < n; ++i) {
      phasor_sample<kPhasorSeries, kNcoSubcarrier>(x, wr, wi, f, as, bs, cw,
                                                   sw, m);
    }
  } else if (kChain == 1) {
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
  } else {
    float4* ab = ring[0] + lane * kProbeStride;
    float4* wq = ring[1] + lane * kProbeStride;
    const float a = __fmul_rn(as, x);
    const float b = __fmul_rn(bs, x);
    for (int q = 0; q < kNcoSlot; ++q) ab[q] = make_float4(a, b, a, b);
    for (long long i = 0; i < n / kNcoPhasorTile; ++i) {
      float m = 0.0f;
      // The slot is read afresh each tile, as after the kernel's wait.
      asm volatile("" : : : "memory");
      chain_tile<kPhasorSeries>(ab, wq, wr, wi, f, cw, sw, m, one);
      far += m > kNcoPsiMax;
      phasor_renorm(wr, wi);
    }
  }
  const long long t1 = clock64();
  if (lane == 0) *(volatile int*)&done = 1;
  result[lane] = far > 0 ? -1.0f : (wr + wi) + f;
  cycles[lane] = t1 - t0;
}

}  // namespace rc

// K-NCO over the pilot `x`, each row scaled by `scale` (1 / RMS, or 1);
// `out` takes `output` a sample (kNcoSubcarrier: -sin 2p; kNcoPhase: p).
// Blocks of `lanes` rows (1..32), each with kNcoHelpers helper warps.
// ak = (ki + kp) / sqrt(2), ai = ki / sqrt(2) and (cw, sw) = e^{j w0},
// float32 from the host. `redone` and `starved` (one unsigned 64-bit count
// each on the device) are added to once a tile done again with sincosf
// and once a tile a chain lane found not yet staged.
extern "C" int rc_nco_pll(const void* x, long long x_stride,
                          const void* scale, const void* phase_in,
                          const void* freq_in, void* out, void* phase_out,
                          void* freq_out, void* redone, void* starved,
                          long long rows, long long n, int lanes, float ak,
                          float ai, float cw, float sw, int output,
                          void* stream) {
  if (rows < 1 || n < 1 || lanes < 1 || lanes > rc::kNcoThreads ||
      (output != rc::kNcoSubcarrier && output != rc::kNcoPhase)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (rows + lanes - 1) / lanes;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long smem = rc::nco_smem_bytes(lanes);
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
  p.starved = (unsigned long long*)starved;
  p.rows = rows;
  p.n = n;
  p.lanes = lanes;
  p.ak = ak;
  p.ai = ai;
  p.cw = cw;
  p.sw = sw;
  p.one = 1.0f;
  // 16-byte accesses need every row on a 16-byte boundary.
  p.vec_x = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) && x_stride % 4 == 0;
  p.vec_out = ((reinterpret_cast<uintptr_t>(out) & 15) == 0) && n % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
  const dim3 block(rc::kNcoThreads * (1 + rc::kNcoHelpers));
  const void* fn =
      output == rc::kNcoSubcarrier
          ? (const void*)rc::nco_pll_kernel_phasor<rc::kNcoSubcarrier>
          : (const void*)rc::nco_pll_kernel_phasor<rc::kNcoPhase>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (output == rc::kNcoSubcarrier) {
    rc::nco_pll_kernel_phasor<rc::kNcoSubcarrier><<<grid, block, smem, s>>>(
        p);
  } else {
    rc::nco_pll_kernel_phasor<rc::kNcoPhase><<<grid, block, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// K-NCO's latency bound: one block with `lanes` chain lanes (1..32) in
// warp 0, each running `n` links of chain `chain` (see
// nco_chain_probe_kernel), and `helpers` (0..3) busy warps beside it;
// `result` and `cycles` take one value per lane. A measuring aid: no path
// calls it.
extern "C" int rc_nco_chain_probe(void* result, void* cycles, long long n,
                                  int chain, int lanes, int helpers, float x,
                                  float kp, float ki, float w0,
                                  void* stream) {
  if (n < 1 || lanes < 1 || lanes > 32 || helpers < 0 ||
      helpers > rc::kNcoHelpers) {
    return (int)cudaErrorInvalidValue;
  }
  float* r = (float*)result;
  long long* c = (long long*)cycles;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = helpers > 0 ? rc::kNcoThreads * (1 + helpers) : lanes;
  switch (chain) {
    case 0:
      rc::nco_chain_probe_kernel<0><<<1, threads, 0, s>>>(r, c, n, lanes, x,
                                                          kp, ki, w0, 1.0f);
      break;
    case 1:
      rc::nco_chain_probe_kernel<1><<<1, threads, 0, s>>>(r, c, n, lanes, x,
                                                          kp, ki, w0, 1.0f);
      break;
    case 2:
      rc::nco_chain_probe_kernel<2><<<1, threads, 0, s>>>(r, c, n, lanes, x,
                                                          kp, ki, w0, 1.0f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
