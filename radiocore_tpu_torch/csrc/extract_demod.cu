// K-XDEMOD and K-XDEMOD-SPEC: fused channel extraction + FM quadrature
// demod (and, for SPEC, the forward DFT of the demodulated signal).
//
// Replaces radiocore_tpu/kernels/extract_demod_pallas.py `_extract_demod_call`
// (body `_extract_demod_kernel`, entry `extract_demod_rows_pallas`) and
// `_extract_demod_spec_call` (body `_extract_demod_spec_kernel`, entry
// `extract_demod_spec_rows_pallas`). For station i, with x~ the backward
// m-point DFT of the windowed, folded run at spectrum bin (a0 + i*m) mod n
// (K-EXTRACT before its (-1)^t flip):
//     quad[t] = gain * atan2(Im P, Re P),  P = -x~[t] * conj(x~[t-1]),
// quad[0] = 0 (the flips of the extracted IQ cancel in the product up to
// that minus sign); SPEC writes bins k < keep of the forward DFT of quad.
//
// The plan (kernels/extract_demod.py) splits m = n1*n2:
//   pass 1  K-EXTRACT's first pass (its kernel lives in extract.cu):
//           extraction load, n1-point DFTs, twiddle, scratch s (station,
//           k1, j2);
//   pass 2  here: n2-point DFT of row s = k1, giving x~[t] at t = s + n1*k,
//           and the demod in the epilogue, so the station IQ never reaches
//           device memory. SPEC goes on in registers: the quad rows of the
//           block are exactly the inputs of the forward transform's first
//           pass under the split j = s + n1*k (n2-point DFT over k for each
//           s), so it runs that DFT, applies the twiddle W_m^(s*k1') and
//           stores scratch t (station, k1', s);
//   pass 3  SPEC only, here: n1-point DFT over s for each k1', storing bin
//           k1' + n2*k2' only where it is < keep (kStoreKeep).
//
// The t-1 neighbour: x~[t-1] is row s-1 at the same k, and for s = 0 it is
// row n1-1 at k-1. A block holds P rows s0..s0+P-1 and one halo row in
// front, row (s0-1) mod n1, transformed with them (1/P extra work), so
// every neighbour is in shared memory. After its transform a thread holds
// its row's x~ at 16 values of k in registers. It writes them to its row
// once (the row after it reads them) and demodulates them against the row
// before it at the same k: one shared load per point. For SPEC the result
// goes straight into the registers the forward transform starts from. The
// quad has s fastest in memory (runs of P floats at a stride of n1), so
// its floats are staged through shared memory, row by row as the threads
// hold them (consecutive k: no bank conflict), and leave as 16-byte
// evict-first stores, four rows of one k per thread; the rows' pitch
// (quad_pitch) spreads the P/4 row groups a warp reads over the banks.
//
// What bounds it on an H100: by the bytes it must move, device memory:
// per station point 8 B of spectrum read and 4 B of quad written (302 MB
// at 96 x 2^18) or 8*keep/m B of SPEC bins (250 MB at keep = 63 601). Run
// pass by pass over the whole batch, the scratch adds 16 B per point and
// pass (0.71 GB in all for the quad, 1.06 GB for SPEC). What it is bound
// by in fact is the instructions of its passes (PERF.md): keeping the
// scratch in the L2 took traffic off device memory and no time off the
// passes, which came from leaner passes instead.
//
// What the design does about it: rc_extract_demod runs the passes per
// group of G stations, the groups dealt over lanes (streams with a scratch
// set each, fft_common.cuh Lanes), all lanes' scratch sized by the host to
// two thirds of the L2 (50 MB on an H100: two lanes of G = 8 for the
// quad's s at 2^18 points); the spectrum read and the quad and keep stores
// are evict-first accesses. The quad gains about 3% from it; SPEC's two
// buffers leave groups of 4 stations, too few blocks per kernel to fill
// the card, so the host runs SPEC over the whole batch (G = c).
//
// The transforms are fft_common.cuh's fft_row (16 points per thread,
// Stockham stages in registers, the global twiddle tables). A block of
// P + 1 rows is (P + 1)*n2/16 threads; the host plan takes P = 8 at
// n2 = 512, 288 threads, and the kernel's launch bounds say so (three
// blocks per SM: 72 registers, no spill), where a bound of 1024 threads
// kept it to 64 registers and spilled. It is built with n2 = 512 as a
// constant (fft_common.cuh kFastLg) and for any n2.
//
// The discriminator is atan2_fast below, not atan2f: one division and an
// odd polynomial of degree 13 on [0, 1], no special cases but the origin,
// which gives 0 (a dead station's product is (-0, -0), where C's atan2f
// gives -pi: its audio would sit at -1).
#include "fft_common.cuh"

// In rc, not an unnamed namespace: nvcc's host stubs cannot name a kernel
// parameter type declared in one.
namespace rc {

struct Demod {
  int L, lg;   // n2 and log2(n2)
  int P, lgP;  // rows per block (power of two dividing S)
  long long S;              // n1 rows per station
  long long B1;             // stations
  long long ib1, is;        // input: station stride, row stride (unit j)
  long long ob1, os, ok;    // output: station stride; (s, k) at s*os + k*ok
  long long tw_n;           // SPEC: m, the forward twiddle's period
  int lgtw;                 // log2(tw_n)
  float gain;
};

// Four-quadrant arctangent, within 2e-6 rad of atan2 for every finite
// input (measured on the card against float64: PERF.md): z = min/max of
// the magnitudes in [0, 1] by one division, atan(z) = z + z^3 Q(z^2) with
// Q the degree-5 minimax fit on [0, 1] (6e-7 with the division's
// rounding), then the octant and quadrant by selects, so a warp does not
// diverge. Conventions: 0 at the origin whatever the zeros' signs; a zero
// y counts as +0 (x > 0 gives 0, x < 0 gives pi), as the JAX package's
// atan2_poly has it. kernels/extract_demod.py atan2_fast_model mirrors it
// coefficient for coefficient.
__device__ __forceinline__ float atan2_fast(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float z = lo / hi;
  z = hi == 0.f ? 0.f : z;  // the origin: 0/0
  const float s = z * z;
  float q = 0.00738483341f;
  q = fmaf(q, s, -0.0355649926f);
  q = fmaf(q, s, 0.0822363347f);
  q = fmaf(q, s, -0.134035528f);
  q = fmaf(q, s, 0.198633403f);
  q = fmaf(q, s, -0.333255589f);
  float r = fmaf(q, z * s, z);
  r = ay > ax ? 1.57079632679489662f - r : r;
  r = x < 0.f ? 3.14159265358979324f - r : r;
  return y < 0.f ? -r : r;
}

// gain * atan2 of -cur * conj(prv): the FM discriminator of neighbours
// x~[t], x~[t-1] (the minus sign is what is left of the (-1)^t flips).
// Exactly 0 where either is 0 (a dead station).
__device__ __forceinline__ float discriminate(float2 cur, float2 prv,
                                              float gain) {
  const float pr = -(cur.x * prv.x + cur.y * prv.y);
  const float pi = -(cur.y * prv.x - cur.x * prv.y);
  return gain * atan2_fast(pi, pr);
}

// The demod pass's block: (P + 1)*L/16 threads at most kDemodThreads
// (kernels/extract_demod.py plans within it), at three blocks per SM for
// the constant-length build (72 registers) and two for the other, which
// needs more.
constexpr int kDemodThreads = 288;

// Floats between the rows of the staged quad: a thread of the store reads
// rows 4j .. 4j + 3 at one k, lane = (k, j) with j fastest, so the P/4 row
// groups of a warp must start 32/(P/4) banks apart: 4*pitch = 128/P mod 32.
__host__ __device__ constexpr int quad_pitch(int L, int P) {
  return L + (P >= 4 && P <= 32 ? 32 / P : 1);
}

template <bool SPEC, int LG>
__global__ void __launch_bounds__(kDemodThreads, LG ? 3 : 2)
    demod_pass_kernel(const float2* __restrict__ in, void* __restrict__ out,
                      Demod d) {
  extern __shared__ float2 smem[];
  const int lg = LG ? LG : d.lg, P = d.P;
  const int T = 1 << (lg - 4);
  const int pitch = row_pitch(1 << lg);
  float2* buf = smem;                            // halo row, then P rows
  const int r = threadIdx.x >> (lg - 4);         // buffer row 0..P
  const int t = threadIdx.x & (T - 1);
  float2* row = buf + r * pitch;

  // Rows and stations are 32-bit here (S <= 4096 rows per station).
  const int rows = (int)d.S;
  const int nsb = rows >> d.lgP;
  const int s0 = (int)(blockIdx.x % nsb) * P;
  const int b1 = (int)(blockIdx.x / nsb);

  // Buffer row r holds sub-FFT row (s0 - 1) mod S (r = 0, the halo) or
  // s0 + r - 1; rows are unit stride, so each thread loads its points.
  const int sr = (r == 0) ? (s0 == 0 ? rows : s0) - 1 : s0 + r - 1;
  float2 v[kVals];
  {
    const float2* src = in + b1 * d.ib1 + sr * d.is + t;
#pragma unroll
    for (int m = 0; m < kVals; ++m) v[m] = src[m * T];
  }
  fft_row(v, row, t, lg, 1.0f);
  row_sync(T);
#pragma unroll
  for (int m = 0; m < kVals; ++m) row[pad(t + m * T)] = v[m];
  __syncthreads();

  // Row s = s0 + r - 1 (buffer row r > 0) has its neighbour x~[t - 1] in
  // buffer row r - 1 at the same k, except for s = 0, whose neighbour is
  // the halo (row n1 - 1) one element back. t = 0 (s = k = 0) gives 0.
  const bool first = (sr == 0) && r > 0;  // s = 0
  const float2* prow = buf + (r > 0 ? r - 1 : 0) * pitch;
  if (!SPEC) {
    // Each thread demodulates its own points (still in v); the halo row's
    // threads have none. The quad is staged where the transformed rows
    // were, P rows of quad_pitch floats: a block that needs no shared
    // memory beyond its rows leaves room on the SM for the other lane's
    // first-pass blocks, which measured faster than a buffer of its own,
    // though that needs one barrier less.
    const int qp = quad_pitch(1 << lg, P);
    float* qs = reinterpret_cast<float*>(buf);
    float q[kVals];
    if (r > 0) {
#pragma unroll
      for (int m = 0; m < kVals; ++m) {
        const int k = t + m * T;
        q[m] = 0.f;
        if (!(first && k == 0)) {
          q[m] = discriminate(v[m], prow[pad(first ? k - 1 : k)], d.gain);
        }
      }
    }
    // Every row has read its neighbour: the quad takes the rows' place.
    __syncthreads();
    if (r > 0) {
      float* qrow = qs + (r - 1) * qp;
#pragma unroll
      for (int m = 0; m < kVals; ++m) qrow[t + m * T] = q[m];
    }
    __syncthreads();
    if (r == 0) return;
    // The store: (s, k) at s*os + k*ok, s fastest. The P*L floats over the
    // P*L/16 threads that are left: four 16-byte stores each where a run of
    // four rows is one aligned access, else 16 scalar ones.
    const int tq = threadIdx.x - T;
    float* qout = (float*)out + b1 * d.ob1 + s0 * d.os;
    if (P >= 4 && d.os == 1 && (d.ok & 3) == 0 && aligned16(qout)) {
      const int lgJ = d.lgP - 2;
      const int j = tq & ((1 << lgJ) - 1);
      const int dk = (P * T) >> lgJ;
      const float* q0 = qs + 4 * j * qp;
      float* dst = qout + 4 * j;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int k = (tq >> lgJ) + it * dk;
        st_once(reinterpret_cast<float4*>(dst + (long long)k * d.ok),
                make_float4(q0[k], q0[qp + k], q0[2 * qp + k],
                            q0[3 * qp + k]));
      }
      return;
    }
#pragma unroll
    for (int it = 0; it < kVals; ++it) {
      const int idx = tq + it * P * T;
      const int p = idx & (P - 1);
      const int k = idx >> d.lgP;
      st_once(qout + p * d.os + (long long)k * d.ok, qs[p * qp + k]);
    }
    return;
  }

  // SPEC: each thread demodulates its own points (still in v) against the
  // row before, and the forward n2-point DFT of the quad row (real input)
  // starts from those registers. The halo row's threads transform zeros to
  // keep the barriers uniform.
#pragma unroll
  for (int m = 0; m < kVals; ++m) {
    const int k = t + m * T;
    float q = 0.f;
    if (r > 0 && !(first && k == 0)) {
      q = discriminate(v[m], prow[pad(first ? k - 1 : k)], d.gain);
    }
    v[m] = make_float2(q, 0.f);
  }
  // Every row has read its neighbour before any row's buffer is reused.
  __syncthreads();
  fft_row(v, row, t, lg, -1.0f);
  row_sync(T);
#pragma unroll
  for (int m = 0; m < kVals; ++m) row[pad(t + m * T)] = v[m];
  __syncthreads();

  // The twiddled half-transform of row s0 + p (buf row p + 1) to scratch,
  // s fastest.
  float2* sout = (float2*)out + b1 * d.ob1;
  if ((blockDim.x & (P - 1)) == 0) {
    // The thread's row s is the same in every iteration and k advances by
    // dk: the twiddle is a geometric sequence (fft_common.cuh store_rows).
    const int p = threadIdx.x & (P - 1);
    const int s = s0 + p;
    const int dk = blockDim.x >> d.lgP;
    const long long mask = d.tw_n - 1;
    const float2 step = tw_four(((long long)s * dk) & mask, d.lgtw, -1.0f);
    const float2* rowp = buf + (p + 1) * pitch;
    float2* dst = sout + s * d.os;
    float2 w = step;
    int k = threadIdx.x >> d.lgP;
#pragma unroll 4
    for (int i = 0; k < (1 << lg); ++i, k += dk) {
      if (i % kTwRun == 0) {
        w = tw_four(((long long)s * k) & mask, d.lgtw, -1.0f);
      }
      dst[(long long)k * d.ok] = cmul(rowp[pad(k)], w);
      w = cmul(w, step);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < (P << lg); idx += blockDim.x) {
    const int p = idx & (P - 1);
    const int k = idx >> d.lgP;
    const int s = s0 + p;
    sout[s * d.os + (long long)k * d.ok] =
        cmul(buf[(p + 1) * pitch + pad(k)],
             tw_four(((long long)s * k) & (d.tw_n - 1), d.lgtw, -1.0f));
  }
}

inline int demod_threads(const Demod& d) { return (d.P + 1) * d.L / kVals; }

// P + 1 transformed rows; the quad's P staged rows reuse their place.
inline size_t demod_smem(const Demod& d) {
  return sizeof(float2) * (size_t)(d.P + 1) * row_pitch(d.L);
}

template <bool SPEC>
static int prepare_demod(const Demod& d) {
  if (d.lg == kFastLg) {
    return prepare_kernel(demod_pass_kernel<SPEC, kFastLg>, demod_smem(d));
  }
  return prepare_kernel(demod_pass_kernel<SPEC, 0>, demod_smem(d));
}

template <bool SPEC>
static int enqueue_demod(const float2* in, void* out, const Demod& d,
                         cudaStream_t stream) {
  const long long blocks = d.B1 * (d.S / d.P);
  if (d.lg == kFastLg) {
    return enqueue(demod_pass_kernel<SPEC, kFastLg>, blocks, demod_threads(d),
                   demod_smem(d), stream, in, out, d);
  }
  return enqueue(demod_pass_kernel<SPEC, 0>, blocks, demod_threads(d),
                 demod_smem(d), stream, in, out, d);
}

// The demod pass from its pass record (the fields of a K-FFT pass that it
// uses); a cudaError_t.
inline int demod_from_record(Demod* out, const long long* r, bool spec,
                             float gain) {
  Demod d;
  d.L = (int)r[0];
  d.lg = log2_exact(d.L);
  d.P = (int)r[1];
  d.lgP = log2_exact(d.P);
  d.S = r[2];
  d.B1 = r[4];
  d.ib1 = r[6];
  d.is = r[7];
  d.ob1 = r[10];
  d.os = r[11];
  d.ok = r[12];
  d.tw_n = r[13];
  d.lgtw = spec ? log2_exact(d.tw_n) : 0;
  d.gain = gain;
  if (d.L < kMinSub || d.L > kMaxSub || d.lg < 0 || d.lgP < 0 ||
      demod_threads(d) > kDemodThreads || d.S < d.P || d.S % d.P != 0 ||
      d.S > kMaxSub || r[3] != 1 || d.B1 < 1 || r[8] != 1 ||
      (spec && (d.tw_n < 2 || d.lgtw < 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (d.B1 * (d.S / d.P) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  *out = d;
  return 0;
}

// atan2_fast on its own, one thread per point: what holds the
// discriminator against float64 on the card.
__global__ void atan2_fast_kernel(const float* __restrict__ y,
                                  const float* __restrict__ x,
                                  float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = atan2_fast(y[i], x[i]);
}

}  // namespace rc

// out[i] = atan2_fast(y[i], x[i]) for n float32 points. Returns a
// cudaError_t.
extern "C" int rc_atan2_fast(const void* y, const void* x, void* out,
                             long long n, void* stream) {
  constexpr int kThreads = 256;
  if (n < 1 || (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  rc::atan2_fast_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                          0, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

// K-XDEMOD (keep = 0): spectrum (n) -> out (c, m) float32 quad; and
// K-XDEMOD-SPEC (keep > 0): -> out (c, keep) complex64. `records` holds the
// plan's passes for the whole batch, the station as their b1 index: first,
// demod and, for SPEC, keep (pass_from_record). They are run per group of
// `group` stations, group i on lane i mod `lanes` over that lane's part of
// the scratch `s` and, for SPEC, `t` (lanes*group*m points each).
// Everything is ordered on `stream` (see Lanes); `*launches` is the number
// of kernels launched. Returns a cudaError_t.
extern "C" int rc_extract_demod(const void* spectrum, void* out, void* s,
                                void* t, const long long* records,
                                long long c, long long group, int lanes,
                                long long n, long long m, long long a0,
                                float gain, long long keep, void* stream,
                                int* launches) {
  using namespace rc;
  *launches = 0;
  const bool spec = keep > 0;
  if (m < 2 || log2_exact(m) < 0 || n < m || a0 < 0 || a0 >= n || c < 1 ||
      c * m > n || group < 1 || keep < 0 || keep > m || s == nullptr ||
      (spec && t == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  Extract e = {n, m, a0, 1.0f / (float)n};
  const Extract none = {1, 2, 0, 0.f};
  Pass first, last;
  Demod demod;
  int err = pass_from_record(&first, records, +1, kStoreStrided);
  if (err) return err;
  err = demod_from_record(&demod, records + kPassFields, spec, gain);
  if (err) return err;
  if (first.B0 != 1 || first.B1 != c || demod.B1 != c) {
    return (int)cudaErrorInvalidValue;
  }
  err = prepare_extract_first(first);
  if (err) return err;
  err = spec ? prepare_demod<true>(demod) : prepare_demod<false>(demod);
  if (err) return err;
  if (spec) {
    err = pass_from_record(&last, records + 2 * kPassFields, -1, kStoreKeep);
    if (err) return err;
    if (last.B0 != 1 || last.B1 != c || last.keep != keep) {
      return (int)cudaErrorInvalidValue;
    }
    err = prepare_pass<kLoadStrided, kStoreKeep>(last);
    if (err) return err;
  }
  Lanes on(lanes);
  err = on.fork(st);
  if (err) return err;
  int lane = 0;
  for (long long g0 = 0; g0 < c && !err;
       g0 += group, lane = (lane + 1) % lanes) {
    const long long cg = (c - g0 < group) ? c - g0 : group;
    first.B1 = demod.B1 = last.B1 = cg;
    e.a0 = (a0 + g0 * m) % n;
    const cudaStream_t ls = on.stream(lane);
    float2* sl = (float2*)s + lane * group * m;
    err = enqueue_extract_first((const float2*)spectrum, sl, first, e, ls);
    if (err) break;
    ++*launches;
    if (!spec) {
      err = enqueue_demod<false>(sl, (float*)out + g0 * demod.ob1, demod, ls);
      if (!err) ++*launches;
      continue;
    }
    float2* tl = (float2*)t + lane * group * m;
    err = enqueue_demod<true>(sl, tl, demod, ls);
    if (err) break;
    ++*launches;
    err = enqueue_pass<kLoadStrided, kStoreKeep>(
        tl, (float2*)out + g0 * last.ob1, last, none, ls);
    if (!err) ++*launches;
  }
  // Joined after a failed launch too (see rc_extract_rows).
  const int joined = on.join();
  return err ? err : joined;
}
