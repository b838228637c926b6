// Lock-free single-producer/single-consumer byte ring for IQ ingest.
//
// Native replacement for the hot host-side memcpys of the reference's
// Python RingBuffer (reference: radiocore/tools/ringbuffer.py:118-122,
// 151-155, guarded there by a mutex + `atomics` package). This ring is
// SPSC: one SDR reader thread, one DSP feeder thread — the exact shape of
// the receiver apps (reference: examples/receive_fm.py:24,67) — so
// acquire/release atomics suffice and copies run without the GIL.
//
// Exposed as a tiny C ABI consumed via ctypes
// (radiocore_tpu_torch/native/build.py); element semantics (dtype,
// overflow policy, blocking) stay in Python for exact reference parity.
// The port keeps its own copy of radiocore_tpu/native/ringbuffer.cpp.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Ring {
  uint8_t* data;
  size_t capacity;                 // bytes
  std::atomic<size_t> head{0};     // producer write offset
  std::atomic<size_t> tail{0};     // consumer read offset
  std::atomic<size_t> occupancy{0};
};

void copy_in(Ring* r, size_t head, const uint8_t* src, size_t n) {
  size_t first = r->capacity - head;
  if (first > n) first = n;
  std::memcpy(r->data + head, src, first);
  if (n > first) std::memcpy(r->data, src + first, n - first);
}

void copy_out(Ring* r, size_t tail, uint8_t* dst, size_t n) {
  size_t first = r->capacity - tail;
  if (first > n) first = n;
  std::memcpy(dst, r->data + tail, first);
  if (n > first) std::memcpy(dst + first, r->data, n - first);
}

}  // namespace

extern "C" {

void* rc_ring_create(size_t capacity) {
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->data = new (std::nothrow) uint8_t[capacity];
  if (!r->data) {
    delete r;
    return nullptr;
  }
  r->capacity = capacity;
  return r;
}

void rc_ring_destroy(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r) return;
  delete[] r->data;
  delete r;
}

size_t rc_ring_capacity(void* ring) {
  return static_cast<Ring*>(ring)->capacity;
}

size_t rc_ring_occupancy(void* ring) {
  return static_cast<Ring*>(ring)->occupancy.load(std::memory_order_acquire);
}

void rc_ring_reset(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->occupancy.store(0, std::memory_order_release);
}

// Returns 1 on success, 0 when n bytes would not fit (caller applies the
// overflow policy), -1 when n exceeds the capacity outright.
int rc_ring_put(void* ring, const uint8_t* src, size_t n) {
  Ring* r = static_cast<Ring*>(ring);
  if (n > r->capacity) return -1;
  size_t occ = r->occupancy.load(std::memory_order_acquire);
  if (n > r->capacity - occ) return 0;
  size_t head = r->head.load(std::memory_order_relaxed);
  copy_in(r, head, src, n);
  r->head.store((head + n) % r->capacity, std::memory_order_relaxed);
  r->occupancy.fetch_add(n, std::memory_order_release);
  return 1;
}

// Returns 1 on success, 0 when fewer than n bytes are available, -1 when
// n exceeds the capacity outright.
int rc_ring_get(void* ring, uint8_t* dst, size_t n) {
  Ring* r = static_cast<Ring*>(ring);
  if (n > r->capacity) return -1;
  size_t occ = r->occupancy.load(std::memory_order_acquire);
  if (n > occ) return 0;
  size_t tail = r->tail.load(std::memory_order_relaxed);
  copy_out(r, tail, dst, n);
  r->tail.store((tail + n) % r->capacity, std::memory_order_relaxed);
  r->occupancy.fetch_sub(n, std::memory_order_release);
  return 1;
}

}  // extern "C"
