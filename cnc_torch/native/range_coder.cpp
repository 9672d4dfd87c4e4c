// Binary range coder for CNC bitstreams (host side).
//
// Replaces the reference's torchac CPU arithmetic coder (utils_bpp_acc.py:77-110):
// two-symbol alphabet with per-symbol probabilities quantized to 16 bits.
// Classic carry-propagating byte-wise range coder (LZMA-style renormalization):
// interval [0, r1) codes symbol 1 (probability p1q/2^16), [r1, range) codes 0.
//
// Exposed through a C ABI for ctypes; probabilities must be identical between
// encode and decode (the caller quantizes once in numpy and reuses).
//
// cnc_torch's own copy of cnc_tpu/native/range_coder.cpp: the streams it
// writes are byte-identical to cnc_tpu's, so a bundle of either package
// decodes in the other.  Change neither copy alone.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kTopValue = 1u << 24;

struct Encoder {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cache_size = 1;  // first shift emits the initial zero cache
  bool overflow = false;

  inline void put_byte(uint8_t b) {
    if (pos < cap) out[pos++] = b;
    else overflow = true;
  }

  inline void shift_low() {
    if (static_cast<uint32_t>(low >> 32) != 0 ||
        static_cast<uint32_t>(low) < 0xFF000000u) {
      uint8_t carry = static_cast<uint8_t>(low >> 32);
      while (cache_size != 0) {
        put_byte(static_cast<uint8_t>(cache + carry));
        cache = 0xFF;
        --cache_size;
      }
      cache = static_cast<uint8_t>(low >> 24);
      cache_size = 0;
    }
    ++cache_size;
    low = (low << 8) & 0xFFFFFFFFu;
  }

  inline void encode_bit(int bit, uint32_t p1q) {
    uint32_t r1 = static_cast<uint32_t>(
        (static_cast<uint64_t>(range) * p1q) >> 16);
    if (r1 == 0) r1 = 1;
    if (r1 >= range) r1 = range - 1;
    if (bit) {
      range = r1;
    } else {
      low += r1;
      range -= r1;
    }
    while (range < kTopValue) {
      shift_low();
      range <<= 8;
    }
  }

  inline void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct Decoder {
  const uint8_t* in;
  int64_t len;
  int64_t pos = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  inline uint8_t next_byte() { return pos < len ? in[pos++] : 0; }

  inline void init() {
    next_byte();  // matches encoder's initial cache byte
    for (int i = 0; i < 4; ++i) code = (code << 8) | next_byte();
  }

  inline int decode_bit(uint32_t p1q) {
    uint32_t r1 = static_cast<uint32_t>(
        (static_cast<uint64_t>(range) * p1q) >> 16);
    if (r1 == 0) r1 = 1;
    if (r1 >= range) r1 = range - 1;
    int bit;
    if (code < r1) {
      bit = 1;
      range = r1;
    } else {
      bit = 0;
      code -= r1;
      range -= r1;
    }
    while (range < kTopValue) {
      code = (code << 8) | next_byte();
      range <<= 8;
    }
    return bit;
  }
};

}  // namespace

extern "C" {

// Encode n bits with per-bit P(1)=probs[i]/65536. Returns bytes written,
// or -1 if out_cap was insufficient.
int64_t rc_encode_bits(const uint8_t* bits, const uint16_t* probs, int64_t n,
                       uint8_t* out, int64_t out_cap) {
  Encoder enc{out, out_cap};
  for (int64_t i = 0; i < n; ++i) {
    enc.encode_bit(bits[i] != 0, probs[i]);
  }
  enc.flush();
  return enc.overflow ? -1 : enc.pos;
}

// Decode n bits from the stream. Returns n on success.
int64_t rc_decode_bits(const uint8_t* stream, int64_t stream_len,
                       const uint16_t* probs, int64_t n, uint8_t* bits_out) {
  Decoder dec{stream, stream_len};
  dec.init();
  for (int64_t i = 0; i < n; ++i) {
    bits_out[i] = static_cast<uint8_t>(dec.decode_bit(probs[i]));
  }
  return n;
}

}  // extern "C"
