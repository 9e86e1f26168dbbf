/* Native TFRecord codec primitives for ddsp_torch's data runtime (a copy of
 * ddsp_tpu/native/tfrecord_codec.c).
 *
 * The training-path IO (ddsp_torch/data/tfrecord.py) parses/writes the
 * TFRecord container format, whose per-record CRC32C (Castagnoli) masks are
 * the dominant cost in pure Python. This module provides a slicing-by-8
 * CRC32C and batch record framing, loaded via ctypes (no pybind11
 * dependency). Python remains the fallback when the shared library is
 * unavailable.
 *
 * Built by ddsp_torch/native/__init__.py into build/ddsp_torch_native/:
 *   cc -O3 -shared -fPIC tfrecord_codec.c -o libtfrecord_codec_<hash>.so
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static uint32_t crc_table[8][256];
static int table_init = 0;

static void init_tables(void) {
  if (table_init) return;
  const uint32_t poly = 0x82F63B78u;
  for (int n = 0; n < 256; n++) {
    uint32_t crc = (uint32_t)n;
    for (int k = 0; k < 8; k++)
      crc = (crc >> 1) ^ (poly & (0u - (crc & 1u)));
    crc_table[0][n] = crc;
  }
  for (int n = 0; n < 256; n++) {
    uint32_t crc = crc_table[0][n];
    for (int k = 1; k < 8; k++) {
      crc = crc_table[0][crc & 0xFF] ^ (crc >> 8);
      crc_table[k][n] = crc;
    }
  }
  table_init = 1;
}

uint32_t ddsp_crc32c(const uint8_t *data, size_t n) {
  init_tables();
  uint32_t crc = 0xFFFFFFFFu;
  /* Slicing-by-8: process 8 bytes per iteration. */
  while (n >= 8) {
    uint64_t word;
    memcpy(&word, data, 8);
    crc ^= (uint32_t)word;
    uint32_t hi = (uint32_t)(word >> 32);
    crc = crc_table[7][crc & 0xFF] ^ crc_table[6][(crc >> 8) & 0xFF] ^
          crc_table[5][(crc >> 16) & 0xFF] ^ crc_table[4][crc >> 24] ^
          crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
          crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = crc_table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t ddsp_masked_crc(const uint8_t *data, size_t n) {
  uint32_t crc = ddsp_crc32c(data, n);
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

/* Frame one record in place: out must hold 8 + 4 + n + 4 bytes.
 * Layout: u64 length | u32 masked_crc(length) | payload | u32
 * masked_crc(payload). Returns bytes written. */
size_t ddsp_frame_record(const uint8_t *payload, size_t n, uint8_t *out) {
  uint64_t len = (uint64_t)n;
  memcpy(out, &len, 8);
  uint32_t len_crc = ddsp_masked_crc(out, 8);
  memcpy(out + 8, &len_crc, 4);
  memcpy(out + 12, payload, n);
  uint32_t data_crc = ddsp_masked_crc(payload, n);
  memcpy(out + 12 + n, &data_crc, 4);
  return 12 + n + 4;
}

/* Verify a framed record starting at buf (remaining bytes m).
 * Returns payload length on success, -1 on truncation, -2 on length-crc
 * mismatch, -3 on data-crc mismatch. */
long long ddsp_check_record(const uint8_t *buf, size_t m) {
  if (m < 16) return -1;
  uint64_t len;
  memcpy(&len, buf, 8);
  uint32_t len_crc;
  memcpy(&len_crc, buf + 8, 4);
  if (ddsp_masked_crc(buf, 8) != len_crc) return -2;
  /* Compare against the remaining space WITHOUT `12 + len + 4`, which
   * overflows for attacker-controlled len near UINT64_MAX and would pass
   * the bound; also reject lengths that alias the error codes. */
  if (len > m - 16) return -1;
  if (len > (uint64_t)1 << 62) return -1;
  uint32_t data_crc;
  memcpy(&data_crc, buf + 12 + len, 4);
  if (ddsp_masked_crc(buf + 12, len) != data_crc) return -3;
  return (long long)len;
}
