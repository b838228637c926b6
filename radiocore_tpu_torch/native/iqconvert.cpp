// Native IQ sample-format conversion for high-rate SDR ingest.
//
// Real SDR front ends emit fixed-point interleaved IQ — RTL-SDR: unsigned
// 8-bit offset-binary; HackRF: signed 8-bit; USRP/SDRplay/Airspy: signed
// 16-bit — while the DSP path consumes complex64 (CF32). The reference
// sidesteps this by requesting CF32 from SoapySDR and letting the driver
// convert (reference: examples/receive_fm.py:33-36, SOAPY_SDR_CF32); for
// file playback and raw drivers the conversion lands on the host CPU at
// stream rate (10-61.44 MS/s => up to ~123 M scalar converts/s), which is
// a hot data-loader path worth native code.
//
// Single-threaded by design: the scale-and-widen loops auto-vectorize
// under -O3 to multi-GB/s, far above any SDR stream rate, and the caller
// (IQFileSource / SDR reader thread) is itself single-threaded SPSC.
// Copies run without the GIL via ctypes. The port keeps its own copy of
// radiocore_tpu/native/iqconvert.cpp.

#include <cstddef>
#include <cstdint>

extern "C" {

// n is the number of SCALAR values (2x the complex sample count).
// All outputs are float32 in [-1, 1).

// RTL-SDR: unsigned 8-bit, zero at 127.5.
void rc_iq_u8_to_f32(const uint8_t* src, float* dst, size_t n) {
  constexpr float k = 1.0f / 127.5f;
  for (size_t i = 0; i < n; ++i) dst[i] = (static_cast<float>(src[i]) - 127.5f) * k;
}

// HackRF and friends: signed 8-bit two's complement.
void rc_iq_s8_to_f32(const int8_t* src, float* dst, size_t n) {
  constexpr float k = 1.0f / 128.0f;
  for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]) * k;
}

// USRP/SDRplay/Airspy: signed 16-bit two's complement (native endian).
void rc_iq_s16_to_f32(const int16_t* src, float* dst, size_t n) {
  constexpr float k = 1.0f / 32768.0f;
  for (size_t i = 0; i < n; ++i) dst[i] = static_cast<float>(src[i]) * k;
}

// Reverse direction (recording / transmit staging). Round-to-nearest:
// halves the quantization error vs truncation.
void rc_iq_f32_to_s16(const float* src, int16_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i] * 32767.0f;
    v += (v >= 0.0f) ? 0.5f : -0.5f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = static_cast<int16_t>(v);
  }
}

}  // extern "C"
