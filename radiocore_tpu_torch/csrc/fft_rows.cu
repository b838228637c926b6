// K-FFT: batched unnormalized power-of-two complex FFT of rows.
//
// Replaces radiocore_tpu/kernels/fft_pallas.py `_fft_call` (body
// `_fft_kernel` / `_dft_row_2d`) and, above one row, the XLA-level
// four-step of `fft_large_pow2_pallas` / `_four_step_pallas`.
//
// What bounds it on an H100: device-memory traffic. Each pass reads and
// writes the whole array once (16 bytes per complex64 point), so a
// transform costs 16 B x points x passes: two passes for the 64 x 2^18
// station rows and for the 2^24 band (4096 x 4096), 268 MB per pass at
// the band size. The arithmetic (5 N log2 N flops) is far below the
// card's float32 rate.
//
// What the design does about it: the TPU kernel held a whole 2 MB row in
// VMEM; a block here has at most 227 KB of shared memory, so a row is cut
// into sub-FFTs of at most 4096 points (fft_common.cuh) and the host plan
// chains the fewest passes that cover it. The four-step twiddle is fused
// into the first pass's store and the last pass stores straight to
// natural order, so no transpose pass or twiddle pass exists. A block
// works on P neighbouring sub-FFTs so that strided loads and stores move
// runs of P points (32 bytes at L = 4096, 256 bytes at L = 512).
#include "fft_common.cuh"

extern "C" int rc_fft_pass(const void* in, void* out, int L, int P,
                           long long S, long long B0, long long B1,
                           long long ib0, long long ib1, long long is,
                           long long ij, long long ob0, long long ob1,
                           long long os, long long ok, long long tw_n,
                           int sign, void* stream) {
  const rc::Extract none = {1, 2, 0, 0.f};
  return rc::launch_pass<rc::kLoadStrided, rc::kStoreStrided>(
      in, out, L, P, S, B0, B1, ib0, ib1, is, ij, ob0, ob1, os, ok, tw_n,
      sign, none, (cudaStream_t)stream);
}
