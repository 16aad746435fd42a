/* crc32c (Castagnoli) — slice-by-8, native runtime component.
 *
 * Role of reference src/common/crc32c* (which dispatches to SSE4/NEON
 * hardware CRC): here a portable table implementation compiled -O3; the
 * Python layer loads it via ctypes (no pybind11 in this image).
 *
 * Polynomial: reflected 0x82F63B78. API: crc32c(seed, buf, len) with the
 * same seed-chaining semantics as ceph_crc32c.
 */

#include <stdint.h>
#include <stddef.h>

static uint32_t T[8][256];
static int initialized = 0;

static void init_tables(void) {
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int j = 0; j < 8; j++)
            c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : (c >> 1);
        T[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = T[0][i];
        for (int s = 1; s < 8; s++) {
            c = T[0][c & 0xff] ^ (c >> 8);
            T[s][i] = c;
        }
    }
    initialized = 1;
}

uint32_t ceph_tpu_crc32c(uint32_t crc, const uint8_t *buf, size_t len) {
    if (!initialized) init_tables();
    crc = ~crc;
    while (len && ((uintptr_t)buf & 7)) {
        crc = T[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
        len--;
    }
    while (len >= 8) {
        uint64_t w = *(const uint64_t *)buf ^ (uint64_t)crc;
        crc = T[7][w & 0xff] ^ T[6][(w >> 8) & 0xff] ^
              T[5][(w >> 16) & 0xff] ^ T[4][(w >> 24) & 0xff] ^
              T[3][(w >> 32) & 0xff] ^ T[2][(w >> 40) & 0xff] ^
              T[1][(w >> 48) & 0xff] ^ T[0][(w >> 56) & 0xff];
        buf += 8;
        len -= 8;
    }
    while (len--) {
        crc = T[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
    }
    return ~crc;
}
