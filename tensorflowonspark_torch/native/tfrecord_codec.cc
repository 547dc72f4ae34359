// Native TFRecord codec: bulk framing encode/decode with crc32c.
//
// Reference anchor: the reference's TFRecord I/O lives in the JVM
// `tensorflow-hadoop` connector jar (SURVEY.md §2.2 — "C++ TFRecord
// reader-writer with a thin binding" is the mandated native equivalent).
// The hot loops (crc32c over every payload, record framing, file scan) run
// here; Python holds the buffers and does one ctypes call per file instead
// of per record.
//
// crc32c: software slice-by-8 (Castagnoli polynomial 0x82F63B78), table
// generated at load time. Masking per the TFRecord spec:
// masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

uint32_t kTable[8][256];
bool table_ready = false;

void init_table() {
  if (table_ready) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++)
      crc = (crc >> 1) ^ (0x82F63B78u & (~(crc & 1) + 1));
    kTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int k = 1; k < 8; k++)
      kTable[k][i] = (kTable[k - 1][i] >> 8) ^ kTable[0][kTable[k - 1][i] & 0xFF];
  table_ready = true;
}

uint32_t crc32c(const uint8_t* data, uint64_t len) {
  init_table();
  uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    crc ^= (uint32_t)data[0] | ((uint32_t)data[1] << 8) |
           ((uint32_t)data[2] << 16) | ((uint32_t)data[3] << 24);
    crc = kTable[7][crc & 0xFF] ^ kTable[6][(crc >> 8) & 0xFF] ^
          kTable[5][(crc >> 16) & 0xFF] ^ kTable[4][crc >> 24] ^
          kTable[3][data[4]] ^ kTable[2][data[5]] ^
          kTable[1][data[6]] ^ kTable[0][data[7]];
    data += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ kTable[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, uint64_t len) {
  uint32_t crc = crc32c(data, len);
  return (uint32_t)(((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

void put_u64le(uint8_t* out, uint64_t v) {
  for (int i = 0; i < 8; i++) out[i] = (uint8_t)(v >> (8 * i));
}
void put_u32le(uint8_t* out, uint32_t v) {
  for (int i = 0; i < 4; i++) out[i] = (uint8_t)(v >> (8 * i));
}
uint64_t get_u64le(const uint8_t* in) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | in[i];
  return v;
}
uint32_t get_u32le(const uint8_t* in) {
  uint32_t v = 0;
  for (int i = 3; i >= 0; i--) v = (v << 8) | in[i];
  return v;
}

}  // namespace

extern "C" {

unsigned int tfr_masked_crc(const unsigned char* data, unsigned long long len) {
  return masked_crc(data, len);
}

// Append n records (payloads concatenated in `data`, split by `lengths`) to
// `path` in TFRecord framing. Returns n, or -1 on I/O error.
long tfr_write(const char* path, const unsigned char* data,
               const unsigned long long* lengths, long n) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  uint8_t header[12], footer[4];
  const uint8_t* p = data;
  for (long i = 0; i < n; i++) {
    uint64_t len = lengths[i];
    put_u64le(header, len);
    put_u32le(header + 8, masked_crc(header, 8));
    put_u32le(footer, masked_crc(p, len));
    if (fwrite(header, 1, 12, f) != 12 || fwrite(p, 1, len, f) != len ||
        fwrite(footer, 1, 4, f) != 4) {
      fclose(f);
      return -1;
    }
    p += len;
  }
  if (fclose(f) != 0) return -1;
  return n;
}

// Scan a TFRecord buffer (whole file, memory-resident): validate framing
// (and CRCs when verify != 0), and fill malloc'd offset/length arrays for
// each payload. Returns record count, -1 on corruption, -2 on truncation.
long tfr_index(const unsigned char* buf, unsigned long long size, int verify,
               uint64_t** offsets, uint64_t** lengths) {
  long cap = 1024, n = 0;
  uint64_t* offs = (uint64_t*)malloc(cap * sizeof(uint64_t));
  uint64_t* lens = (uint64_t*)malloc(cap * sizeof(uint64_t));
  if (!offs || !lens) { free(offs); free(lens); return -1; }
  uint64_t pos = 0;
  while (pos < size) {
    uint64_t avail = size - pos;
    if (avail < 12) { free(offs); free(lens); return -2; }
    uint64_t len = get_u64le(buf + pos);
    if (verify && masked_crc(buf + pos, 8) != get_u32le(buf + pos + 8)) {
      free(offs); free(lens); return -1;
    }
    // overflow-safe: a huge/garbage len must not wrap the arithmetic
    if (avail < 16 || len > avail - 16) { free(offs); free(lens); return -2; }
    const uint8_t* payload = buf + pos + 12;
    if (verify && masked_crc(payload, len) != get_u32le(payload + len)) {
      free(offs); free(lens); return -1;
    }
    if (n == cap) {
      cap *= 2;
      uint64_t* no = (uint64_t*)realloc(offs, cap * sizeof(uint64_t));
      uint64_t* nl = (uint64_t*)realloc(lens, cap * sizeof(uint64_t));
      if (!no || !nl) {  // keep originals freeable on partial failure
        free(no ? no : offs);
        free(nl ? nl : lens);
        return -1;
      }
      offs = no;
      lens = nl;
    }
    offs[n] = pos + 12;
    lens[n] = len;
    n++;
    pos += 12 + len + 4;
  }
  *offsets = offs;
  *lengths = lens;
  return n;
}

void tfr_free(void* p) { free(p); }

}  // extern "C"
