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
//   pass 1  K-EXTRACT's first pass (rc_extract_pass): extraction load,
//           n1-point DFTs, twiddle, scratch (station, k1, j2);
//   pass 2  here: n2-point DFT of row s = k1, giving x~[t] at t = s + n1*k,
//           and the demod in the epilogue, so the station IQ never reaches
//           device memory. SPEC goes on in shared memory: the quad rows of
//           the block are exactly the inputs of the forward transform's
//           first pass under the split j = s + n1*k (n2-point DFT over k
//           for each s), so it runs that DFT, applies the twiddle
//           W_m^(s*k1') and stores (station, k1', s);
//   pass 3  SPEC only, here: n1-point DFT over s for each k1', storing bin
//           k1' + n2*k2' only where it is < keep (kStoreKeep).
//
// The t-1 neighbour: x~[t-1] is row s-1 at the same k, and for s = 0 it is
// row n1-1 at k-1. A block holds P rows s0..s0+P-1 and one halo row in
// front, row (s0-1) mod n1, transformed with them (1/P extra work), so
// every neighbour is in shared memory.
//
// What bounds it on an H100: device-memory traffic, as for K-EXTRACT: per
// station point, pass 1 reads 8 B and writes 8 B, pass 2 reads 8 B (plus
// the halo) and writes 4 B (quad) or 8 B (SPEC), pass 3 reads 8 B and
// writes 8*keep/m B: at 96 x 2^18 (keep = 63 601 for SPEC) about 0.71 GB
// for the quad and 1.06 GB for SPEC. The transforms are fft_common.cuh's
// fft_row (16 points per thread, Stockham stages in registers, the
// global twiddle tables); a block of P + 1 rows is (P + 1)*n2/16 threads,
// so the host plan takes P = 16 at n2 = 512 (about 106 KB of shared
// memory for SPEC, two blocks per SM).
#include "fft_common.cuh"

// In rc, not an unnamed namespace: nvcc's host stubs cannot name a kernel
// parameter type declared in one.
namespace rc {

struct Demod {
  int L, lg;   // n2 and log2(n2)
  int P, lgP;  // rows per block (power of two dividing S)
  long long S;              // n1 rows per station
  long long ib1, is;        // input: station stride, row stride (unit j)
  long long ob1, os, ok;    // output: station stride; (s, k) at s*os + k*ok
  long long tw_n;           // SPEC: m, the forward twiddle's period
  int lgtw;                 // log2(tw_n)
  float gain;
};

template <bool SPEC>
__global__ void __launch_bounds__(1024)
    demod_pass_kernel(const float2* __restrict__ in, void* __restrict__ out,
                      Demod d) {
  extern __shared__ float2 smem[];
  const int lg = d.lg, P = d.P;
  const int T = 1 << (lg - 4);
  const int pitch = row_pitch(d.L);
  float2* buf = smem;                            // halo row, then P rows
  float* qs = (float*)(buf + (P + 1) * pitch);   // SPEC: P*L quad values
  const int r = threadIdx.x >> (lg - 4);         // buffer row 0..P
  const int t = threadIdx.x & (T - 1);
  float2* row = buf + r * pitch;

  const long long nsb = d.S / P;
  const long long s0 = (blockIdx.x % nsb) * P;
  const long long b1 = blockIdx.x / nsb;
  const float2* src = in + b1 * d.ib1;

  // Buffer row r holds sub-FFT row (s0 - 1) mod S (r = 0, the halo) or
  // s0 + r - 1; rows are unit stride, so each thread loads its points.
  const long long sr = (r == 0) ? (s0 + d.S - 1) % d.S : s0 + r - 1;
  float2 v[kVals];
#pragma unroll
  for (int m = 0; m < kVals; ++m) v[m] = src[sr * d.is + t + m * T];
  fft_row(v, row, t, lg, 1.0f);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kVals; ++m) row[pad(t + m * T)] = v[m];
  __syncthreads();

  // Row s = s0 + p is buf row p + 1; its neighbour row is buf row p (the
  // halo for p = 0), except for s = 0, whose neighbour is the halo (row
  // n1 - 1) one element back. t = 0 (s = k = 0) gives 0.
  const int npts = P << lg;
  float* qout = (float*)out + b1 * d.ob1;
  for (int idx = threadIdx.x; idx < npts; idx += blockDim.x) {
    const int p = idx & (P - 1);  // s fastest: neighbouring t, coalesced
    const int k = idx >> d.lgP;
    const long long s = s0 + p;
    float q = 0.f;
    if (s != 0 || k != 0) {
      const float2 cur = buf[(p + 1) * pitch + pad(k)];
      const float2 prv = (s != 0) ? buf[p * pitch + pad(k)] : buf[pad(k - 1)];
      const float pr = -(cur.x * prv.x + cur.y * prv.y);
      const float pi = -(cur.y * prv.x - cur.x * prv.y);
      q = d.gain * atan2f(pi, pr);
    }
    if (SPEC) {
      qs[p * d.L + k] = q;
    } else {
      qout[s * d.os + (long long)k * d.ok] = q;
    }
  }
  if (!SPEC) return;
  __syncthreads();

  // Forward n2-point DFT of each quad row (real input), then the twiddle.
  // Buffer row P's threads transform zeros to keep the barriers uniform.
#pragma unroll
  for (int m = 0; m < kVals; ++m) {
    v[m] = make_float2(r < P ? qs[r * d.L + t + m * T] : 0.f, 0.f);
  }
  fft_row(v, row, t, lg, -1.0f);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kVals; ++m) row[pad(t + m * T)] = v[m];
  __syncthreads();

  float2* sout = (float2*)out + b1 * d.ob1;
  for (int idx = threadIdx.x; idx < npts; idx += blockDim.x) {
    const int p = idx & (P - 1);
    const int k = idx >> d.lgP;
    const long long s = s0 + p;
    sout[s * d.os + (long long)k * d.ok] =
        cmul(buf[p * pitch + pad(k)],
             tw_four((s * k) & (d.tw_n - 1), d.lgtw, -1.0f));
  }
}

}  // namespace rc

// Pass 2 (see above). `spec` = 0 writes quad (float32) to `out`; 1 writes
// the twiddled forward half-transform (complex64) for pass 3.
extern "C" int rc_demod_pass(const void* in, void* out, int spec, int L,
                             int P, long long S, long long B1, long long ib1,
                             long long is, long long ob1, long long os,
                             long long ok, long long tw_n, float gain,
                             void* stream) {
  rc::Demod d;
  d.L = L;
  d.lg = rc::log2_exact(L);
  d.P = P;
  d.lgP = rc::log2_exact(P);
  d.S = S;
  d.ib1 = ib1;
  d.is = is;
  d.ob1 = ob1;
  d.os = os;
  d.ok = ok;
  d.tw_n = tw_n;
  d.lgtw = spec ? rc::log2_exact(tw_n) : 0;
  d.gain = gain;
  if (L < rc::kMinSub || L > rc::kMaxSub || d.lg < 0 || d.lgP < 0 ||
      (long long)(P + 1) * L > rc::kBlockPoints || S < P || S % P != 0 ||
      B1 < 1 || (spec && (tw_n < 2 || d.lgtw < 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = B1 * (S / P);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int err = rc::ensure_tables();
  if (err) return err;
  const size_t smem = sizeof(float2) * (size_t)(P + 1) * rc::row_pitch(L) +
                      (spec ? sizeof(float) * (size_t)P * L : 0);
  const int threads = (P + 1) * L / rc::kVals;
  const cudaStream_t st = (cudaStream_t)stream;
  if (spec) {
    err = (int)cudaFuncSetAttribute(rc::demod_pass_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    rc::demod_pass_kernel<true><<<(unsigned)blocks, threads, smem, st>>>(
        (const float2*)in, out, d);
  } else {
    err = (int)cudaFuncSetAttribute(rc::demod_pass_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
    rc::demod_pass_kernel<false><<<(unsigned)blocks, threads, smem, st>>>(
        (const float2*)in, out, d);
  }
  return (int)cudaGetLastError();
}

// Pass 3 of SPEC: a K-FFT pass (forward) whose store keeps only the
// elements s*os + k*ok < keep of each (b0, b1) output row.
extern "C" int rc_keep_pass(const void* in, void* out, int L, int P,
                            long long S, long long B0, long long B1,
                            long long ib0, long long ib1, long long is,
                            long long ij, long long ob0, long long ob1,
                            long long os, long long ok, long long tw_n,
                            int sign, long long keep, void* stream) {
  const rc::Extract none = {1, 2, 0, 0.f};
  return rc::launch_pass<rc::kLoadStrided, rc::kStoreKeep>(
      in, out, L, P, S, B0, B1, ib0, ib1, is, ij, ob0, ob1, os, ok, tw_n,
      sign, none, (cudaStream_t)stream, keep);
}
