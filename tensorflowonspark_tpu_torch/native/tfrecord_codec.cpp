// The PyTorch port's copy of native/tfrecord_codec.cpp (same framing, same
// C interface): data/tfrecord.py builds it with g++ into build/tfrecord/ at
// first use and loads it with ctypes, so files written by either package's
// codec read in the other's. One change: a length cut short at the end of
// a file is reported as corruption (-2), not as a clean end of file, as
// the pure-Python reader of either package reports it.
//
// Native TFRecord codec: masked-CRC32C record framing, buffered IO, with
// no dependency beyond the C++ standard library, exposed through a C ABI
// for ctypes (TensorFlowOnSpark read and wrote TFRecords through the
// tensorflow-hadoop jar, dfutil.py:39,63).
//
// File format (TFRecord):
//   uint64 length (LE) | uint32 masked_crc32c(length) | bytes data |
//   uint32 masked_crc32c(data)
// masked_crc = ((crc >> 15) | (crc << 17)) + 0xa282ead8
//
// CRC32C (Castagnoli) uses SSE4.2 hardware instructions when available at
// runtime, with a table-driven software fallback.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if (defined(__x86_64__) || defined(__i386__)) && defined(__SSE4_2__)
#include <cpuid.h>
#include <nmmintrin.h>
#define TOS_X86 1
#endif

namespace {

// ---------------- CRC32C ----------------

uint32_t crc_table[8][256];
bool table_ready = false;

void init_table() {
  if (table_ready) return;
  const uint32_t poly = 0x82f63b78u;  // reversed Castagnoli
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = crc_table[0][i];
    for (int s = 1; s < 8; s++) {
      c = crc_table[0][c & 0xff] ^ (c >> 8);
      crc_table[s][i] = c;
    }
  }
  table_ready = true;
}

uint32_t crc32c_sw(uint32_t crc, const uint8_t* data, size_t len) {
  init_table();
  crc = ~crc;
  // slice-by-8
  while (len >= 8) {
    crc ^= (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
           ((uint32_t)data[2] << 16) | ((uint32_t)data[3] << 24);
    uint32_t hi = (uint32_t)data[4] | ((uint32_t)data[5] << 8) |
                  ((uint32_t)data[6] << 16) | ((uint32_t)data[7] << 24);
    crc = crc_table[7][crc & 0xff] ^ crc_table[6][(crc >> 8) & 0xff] ^
          crc_table[5][(crc >> 16) & 0xff] ^ crc_table[4][crc >> 24] ^
          crc_table[3][hi & 0xff] ^ crc_table[2][(hi >> 8) & 0xff] ^
          crc_table[1][(hi >> 16) & 0xff] ^ crc_table[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = crc_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return ~crc;
}

#ifdef TOS_X86
bool have_sse42() {
  static int cached = -1;
  if (cached < 0) {
    unsigned a, b, c, d;
    cached = (__get_cpuid(1, &a, &b, &c, &d) && (c & bit_SSE4_2)) ? 1 : 0;
  }
  return cached == 1;
}

uint32_t crc32c_hw(uint32_t crc, const uint8_t* data, size_t len) {
  crc = ~crc;
  uint64_t c64 = crc;
  while (len >= 8) {
    c64 = _mm_crc32_u64(c64, *reinterpret_cast<const uint64_t*>(data));
    data += 8;
    len -= 8;
  }
  crc = (uint32_t)c64;
  while (len--) crc = _mm_crc32_u8(crc, *data++);
  return ~crc;
}
#endif

uint32_t crc32c(const uint8_t* data, size_t len) {
#ifdef TOS_X86
  if (have_sse42()) return crc32c_hw(0, data, len);
#endif
  return crc32c_sw(0, data, len);
}

uint32_t masked_crc(const uint8_t* data, size_t len) {
  uint32_t crc = crc32c(data, len);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------- reader / writer ----------------

struct Writer {
  FILE* f;
};

struct Reader {
  FILE* f;
  std::vector<uint8_t> buf;
};

}  // namespace

extern "C" {

uint32_t tos_masked_crc32c(const uint8_t* data, size_t len) {
  return masked_crc(data, len);
}

void* tos_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer{f};
  return w;
}

// returns 0 on success
int tos_writer_write(void* handle, const uint8_t* data, uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  uint64_t len_le = len;  // assume little-endian host (x86/arm64)
  uint32_t len_crc = masked_crc(reinterpret_cast<uint8_t*>(&len_le), 8);
  uint32_t data_crc = masked_crc(data, len);
  if (fwrite(&len_le, 8, 1, w->f) != 1) return 1;
  if (fwrite(&len_crc, 4, 1, w->f) != 1) return 1;
  if (len && fwrite(data, 1, len, w->f) != len) return 1;
  if (fwrite(&data_crc, 4, 1, w->f) != 1) return 1;
  return 0;
}

int tos_writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  int rc = fclose(w->f);
  delete w;
  return rc;
}

void* tos_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  return new Reader{f, {}};
}

// Reads the next record. Returns length >= 0, -1 on EOF, -2 on corruption.
// The data pointer (valid until the next call) is stored into *out.
int64_t tos_reader_next(void* handle, const uint8_t** out) {
  auto* r = static_cast<Reader*>(handle);
  uint64_t len_le;
  uint32_t len_crc, data_crc;
  size_t got = fread(&len_le, 1, 8, r->f);
  if (got == 0) return -1;  // clean EOF
  if (got != 8) return -2;  // a header cut short
  if (fread(&len_crc, 4, 1, r->f) != 1) return -2;
  if (masked_crc(reinterpret_cast<uint8_t*>(&len_le), 8) != len_crc)
    return -2;
  if (len_le > (1ull << 40)) return -2;  // absurd length = corruption
  r->buf.resize(len_le);
  if (len_le && fread(r->buf.data(), 1, len_le, r->f) != len_le) return -2;
  if (fread(&data_crc, 4, 1, r->f) != 1) return -2;
  if (masked_crc(r->buf.data(), len_le) != data_crc) return -2;
  *out = r->buf.data();
  return static_cast<int64_t>(len_le);
}

int tos_reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  int rc = fclose(r->f);
  delete r;
  return rc;
}

}  // extern "C"
