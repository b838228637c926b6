// K-EXTRACT: fused channel extraction from the band spectrum.
//
// Replaces radiocore_tpu/kernels/extract_pallas.py `_extract_call` (body
// `_extract_kernel`, entry `extract_rows_pallas`). For station i it takes
// the m-bin run starting at spectrum bin (a0 + i*m) mod n, applies the
// closed-form hann window 0.5*s_norm*(1 + cos(2*pi*(k - m/2)/n)), folds
// the next run's first bin into u[0] (Nyquist fold), takes the backward
// m-point DFT and applies the (-1)^t roll flip.
//
// What bounds it on an H100: device-memory traffic, 16 B per station
// point per pass: one read of the station runs of the spectrum, one write
// of the station IQ, and one scratch round trip between the two passes of
// a 2^18-point station (512 x 512). 64 x 2^18 stations move about
// 3 x 268 MB.
//
// What the design does about it: the window, fold and scale are the load
// prologue of the first FFT pass and the flip is the store epilogue of
// the last (fft_common.cuh), so no windowed or reordered copy of the
// spectrum ever exists; the run is read in place with the modular start
// (any a0, wrapping at n).
#include "fft_common.cuh"

extern "C" int rc_extract_pass(const void* in, void* out, int load_mode,
                               int store_mode, int L, int P, long long S,
                               long long B0, long long B1, long long ib0,
                               long long ib1, long long is, long long ij,
                               long long ob0, long long ob1, long long os,
                               long long ok, long long tw_n, int sign,
                               long long n, long long m, long long a0,
                               float s_norm, void* stream) {
  const rc::Extract e = {n, m, a0, s_norm};
  const cudaStream_t st = (cudaStream_t)stream;
  if (m < 2 || rc::log2_exact(m) < 0 || n < m || a0 < 0 || a0 >= n) {
    return (int)cudaErrorInvalidValue;
  }
  if (load_mode == rc::kLoadExtract && store_mode == rc::kStoreFlip) {
    return rc::launch_pass<rc::kLoadExtract, rc::kStoreFlip>(
        in, out, L, P, S, B0, B1, ib0, ib1, is, ij, ob0, ob1, os, ok, tw_n,
        sign, e, st);
  }
  if (load_mode == rc::kLoadExtract && store_mode == rc::kStoreStrided) {
    return rc::launch_pass<rc::kLoadExtract, rc::kStoreStrided>(
        in, out, L, P, S, B0, B1, ib0, ib1, is, ij, ob0, ob1, os, ok, tw_n,
        sign, e, st);
  }
  if (load_mode == rc::kLoadStrided && store_mode == rc::kStoreFlip) {
    return rc::launch_pass<rc::kLoadStrided, rc::kStoreFlip>(
        in, out, L, P, S, B0, B1, ib0, ib1, is, ij, ob0, ob1, os, ok, tw_n,
        sign, e, st);
  }
  return (int)cudaErrorInvalidValue;
}
