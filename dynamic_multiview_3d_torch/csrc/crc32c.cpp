// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of a byte range,
// slicing by 8: the checksum TensorFlow's tensor bundles keep of every
// tensor (train/tf1.py). A bundle holds megabytes of tensor data, which a
// table loop in Python walks at a few MB/s. Built with g++ at first use
// (utils/cxx.py) and called through ctypes.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "the 8-byte step below reads words little-endian"
#endif

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (int i = 0; i < 256; ++i)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const Tables& tables() {
  static const Tables tables;  // initialised once, thread-safe
  return tables;
}

}  // namespace

extern "C" {

// The CRC-32C of p[0, n) (initial value and final xor 0xFFFFFFFF, as
// crc32c of RFC 3720 and TensorFlow's crc32c::Value).
uint32_t dmv3d_crc32c(const uint8_t* p, uint64_t n) {
  const auto& t = tables().t;
  uint32_t crc = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    w ^= crc;
    crc = t[7][w & 0xFF] ^ t[6][(w >> 8) & 0xFF] ^ t[5][(w >> 16) & 0xFF] ^
          t[4][(w >> 24) & 0xFF] ^ t[3][(w >> 32) & 0xFF] ^
          t[2][(w >> 40) & 0xFF] ^ t[1][(w >> 48) & 0xFF] ^ t[0][w >> 56];
  }
  for (; n; ++p, --n) crc = t[0][(crc ^ *p) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
