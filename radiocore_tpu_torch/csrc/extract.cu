// K-EXTRACT: fused channel extraction from the band spectrum.
//
// Replaces radiocore_tpu/kernels/extract_pallas.py `_extract_call` (body
// `_extract_kernel`, entry `extract_rows_pallas`). For station i it takes
// the m-bin run starting at spectrum bin (a0 + i*m) mod n, applies the
// closed-form hann window 0.5*s_norm*(1 + cos(2*pi*(k - m/2)/n)), folds
// the next run's first bin into u[0] (Nyquist fold), takes the backward
// m-point DFT and applies the (-1)^t roll flip.
//
// What bounds it on an H100: by the bytes it must move, device memory,
// 16 B per station point: one read of the station runs of the spectrum
// and one write of the station IQ (268 MB at 64 x 2^18). A 2^18-point
// station is two passes (512 x 512) with a scratch round trip between
// them; run pass by pass over the whole batch, that scratch (another
// 268 MB written and read back) goes through device memory too. What it
// is bound by in fact is the instructions of its passes (PERF.md).
//
// What the design does about it: the window, fold and scale are the load
// prologue of the first FFT pass and the flip is the store epilogue of
// the last (fft_common.cuh), so no windowed or reordered copy of the
// spectrum ever exists; the run is read in place with the modular start
// (any a0, wrapping at n), two bins per 16-byte access where a0 is even.
// rc_extract_rows runs the two passes per group of G stations, the groups
// dealt over lanes (streams with a scratch of G stations each, which the
// lane's next group overwrites; fft_common.cuh Lanes), so that a group's
// scratch is read back from the L2 and kernels of neighbouring groups
// overlap. The host sizes all lanes' scratch to two thirds of the L2
// (50 MB on an H100: two lanes of G = 8, 32 MB, at 2^18 points). The
// spectrum read and the result store are evict-first accesses (ld_once,
// st_pass), which keeps them from displacing the scratch. PERF.md has the
// measured times per G and lane count.
#include "fft_common.cuh"

namespace rc {

int prepare_extract_first(const Pass& d) {
  return prepare_pass<kLoadExtract, kStoreStrided>(d);
}

int enqueue_extract_first(const float2* spec, float2* out, const Pass& d,
                          const Extract& e, cudaStream_t stream) {
  return enqueue_pass<kLoadExtract, kStoreStrided>(spec, out, d, e, stream);
}

namespace {

// Side streams and events of one device, made at first use and kept.
struct SideStreams {
  bool made = false;
  cudaStream_t stream[kMaxLanes - 1];
  cudaEvent_t fork, join[kMaxLanes - 1];
};

std::mutex g_lanes_mutex;
SideStreams g_side[256];

}  // namespace

Lanes::Lanes(int count) : count_(count) { g_lanes_mutex.lock(); }

Lanes::~Lanes() { g_lanes_mutex.unlock(); }

int Lanes::fork(cudaStream_t caller) {
  streams_[0] = caller;
  if (count_ < 1 || count_ > kMaxLanes) return (int)cudaErrorInvalidValue;
  if (count_ == 1) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 256) return (int)cudaErrorInvalidDevice;
  SideStreams& side = g_side[dev];
  if (!side.made) {
    err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < kMaxLanes - 1; ++i) {
      err = cudaStreamCreateWithFlags(&side.stream[i], cudaStreamNonBlocking);
      if (err != cudaSuccess) return (int)err;
      err = cudaEventCreateWithFlags(&side.join[i], cudaEventDisableTiming);
      if (err != cudaSuccess) return (int)err;
    }
    side.made = true;
  }
  fork_ = side.fork;
  err = cudaEventRecord(fork_, caller);
  if (err != cudaSuccess) return (int)err;
  for (int i = 1; i < count_; ++i) {
    streams_[i] = side.stream[i - 1];
    joins_[i] = side.join[i - 1];
    err = cudaStreamWaitEvent(streams_[i], fork_, 0);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int Lanes::join() {
  for (int i = 1; i < count_; ++i) {
    cudaError_t err = cudaEventRecord(joins_[i], streams_[i]);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamWaitEvent(streams_[0], joins_[i], 0);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace rc

// The L2 cache size of the current device, in bytes.
extern "C" int rc_l2_cache_bytes(long long* bytes) {
  int dev = 0, l2 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return (int)err;
  *bytes = l2;
  return 0;
}

// K-EXTRACT: spectrum (n) -> out (c, m), station i's run at bin
// (a0 + i*m) mod n, scaled by s_norm.
// `records` holds the plan's `npass` passes (1 or 2) for the whole batch
// (pass_from_record); a two-pass plan has the station as its b1 index and
// is run per group of `group` stations, group i on lane i mod `lanes` over
// that lane's part of `scratch` (lanes*group*m points); a one-pass plan has
// no scratch and takes group >= c. Everything is ordered on `stream` (see
// Lanes); `*launches` is the number of kernels launched. Returns a
// cudaError_t.
extern "C" int rc_extract_rows(const void* spectrum, void* out, void* scratch,
                               const long long* records, int npass,
                               long long c, long long group, int lanes,
                               long long n, long long m, long long a0,
                               float s_norm, void* stream,
                               int* launches) {
  using namespace rc;
  *launches = 0;
  if (m < 2 || log2_exact(m) < 0 || n < m || a0 < 0 || a0 >= n || c < 1 ||
      c * m > n || group < 1 || npass < 1 || npass > 2 ||
      (npass == 1 && group < c) || (npass == 2 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float2* spec = (const float2*)spectrum;
  Extract e = {n, m, a0, s_norm};
  Pass first, last;
  if (npass == 1) {
    int err = pass_from_record(&first, records, +1, kStoreFlip);
    if (err) return err;
    err = prepare_pass<kLoadExtract, kStoreFlip>(first);
    if (err) return err;
    err = enqueue_pass<kLoadExtract, kStoreFlip>(spec, (float2*)out, first, e,
                                                 st);
    if (err) return err;
    *launches = 1;
    return 0;
  }
  int err = pass_from_record(&first, records, +1, kStoreStrided);
  if (err) return err;
  err = pass_from_record(&last, records + kPassFields, +1, kStoreFlip);
  if (err) return err;
  if (first.B0 != 1 || last.B0 != 1 || first.B1 != c || last.B1 != c) {
    return (int)cudaErrorInvalidValue;
  }
  err = prepare_extract_first(first);
  if (err) return err;
  err = prepare_pass<kLoadStrided, kStoreFlip>(last);
  if (err) return err;
  Lanes on(lanes);
  err = on.fork(st);
  if (err) return err;
  int lane = 0;
  for (long long g0 = 0; g0 < c && !err;
       g0 += group, lane = (lane + 1) % lanes) {
    first.B1 = last.B1 = (c - g0 < group) ? c - g0 : group;
    e.a0 = (a0 + g0 * m) % n;
    float2* s = (float2*)scratch + lane * group * m;
    err = enqueue_extract_first(spec, s, first, e, on.stream(lane));
    if (err) break;
    ++*launches;
    err = enqueue_pass<kLoadStrided, kStoreFlip>(
        s, (float2*)out + g0 * last.ob1, last, e, on.stream(lane));
    if (!err) ++*launches;
  }
  // Joined after a failed launch too: the caller's stream must wait for
  // what the lanes already hold before the scratch is freed.
  const int joined = on.join();
  return err ? err : joined;
}
