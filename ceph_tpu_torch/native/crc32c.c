/* crc32c (Castagnoli), native runtime component.
 *
 * Role of reference src/common/crc32c*: ceph_choose_crc32 picks a
 * hardware loop by the CPU's features and keeps a table loop for the
 * rest.  So does this file.  Its paths, named by ceph_tpu_crc32c_path():
 *
 *   "sse4.2-3way"  x86-64 with SSE4.2: three independent _mm_crc32_u64
 *                  streams over three adjacent blocks (8 KiB, then 512 B
 *                  for what is left), merged once a round by shifting the
 *                  first streams' CRCs over the later blocks' zero bytes
 *                  with tables computed at load; a one-stream loop for
 *                  inputs shorter than a round, bytes for the head and
 *                  tail that are not 8-byte words.
 *   "armv8-crc"    aarch64 with the CRC32 extension (HWCAP_CRC32): one
 *                  __crc32cd stream.
 *   "table"        anything else: the portable slice-by-8 loop.
 *
 * The path is chosen once per process, when the library is loaded, from
 * the CPU's feature bits (__builtin_cpu_supports on x86-64, getauxval on
 * aarch64); the target attributes below keep the build's flags portable.
 * Every path gives the same values.  The Python layer loads this file
 * via ctypes (no pybind11 in this image).
 *
 * Polynomial: reflected 0x82F63B78. API: ceph_tpu_crc32c(seed, buf, len)
 * with the same seed-chaining semantics as ceph_crc32c.  Calls through it
 * are counted by the path that served them (ceph_tpu_crc32c_stats);
 * ceph_tpu_crc32c_table and, on x86-64 and aarch64, ceph_tpu_crc32c_hw
 * run one path each, uncounted, for the tests that compare paths.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#if defined(__x86_64__)
#include <nmmintrin.h>
#elif defined(__aarch64__)
#include <arm_acle.h>
#include <sys/auxv.h>
#endif

typedef uint32_t (*crc_fn)(uint32_t, const uint8_t *, size_t);

static uint32_t T[8][256];

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
}

uint32_t ceph_tpu_crc32c_table(uint32_t crc, const uint8_t *buf,
                               size_t len) {
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

static inline uint64_t load64(const uint8_t *p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
}

#if defined(__x86_64__)

#define LONG_BLOCK 8192
#define SHORT_BLOCK 512

/* shift_*[k][b]: the raw CRC register that starts as b << 8k and then
 * takes one block of zero bytes.  The map is linear in the register, so
 * four lookups shift any register over a block. */
static uint32_t shift_long[4][256], shift_short[4][256];

static void init_shift(uint32_t t[4][256], size_t block) {
    uint32_t basis[32];
    for (int i = 0; i < 32; i++) {
        uint32_t c = 1u << i;
        for (size_t n = 0; n < block; n++)
            c = T[0][c & 0xff] ^ (c >> 8);
        basis[i] = c;
    }
    for (int k = 0; k < 4; k++)
        for (int b = 0; b < 256; b++) {
            uint32_t c = 0;
            for (int j = 0; j < 8; j++)
                if (b >> j & 1)
                    c ^= basis[8 * k + j];
            t[k][b] = c;
        }
}

static inline uint32_t shift(const uint32_t t[4][256], uint32_t c) {
    return t[0][c & 0xff] ^ t[1][(c >> 8) & 0xff] ^
           t[2][(c >> 16) & 0xff] ^ t[3][c >> 24];
}

/* Three streams over rounds of three adjacent blocks: the register after
 * a round is shift(shift(c0) ^ c1) ^ c2, where c1 and c2 start from 0. */
__attribute__((target("sse4.2")))
static inline uint64_t rounds3(uint64_t c0, const uint8_t **bufp,
                               size_t *lenp, size_t block,
                               const uint32_t t[4][256]) {
    const uint8_t *buf = *bufp;
    size_t len = *lenp;
    while (len >= 3 * block) {
        uint64_t c1 = 0, c2 = 0;
        for (size_t i = 0; i < block; i += 8) {
            c0 = _mm_crc32_u64(c0, load64(buf + i));
            c1 = _mm_crc32_u64(c1, load64(buf + block + i));
            c2 = _mm_crc32_u64(c2, load64(buf + 2 * block + i));
        }
        c0 = shift(t, (uint32_t)c0) ^ c1;
        c0 = shift(t, (uint32_t)c0) ^ c2;
        buf += 3 * block;
        len -= 3 * block;
    }
    *bufp = buf;
    *lenp = len;
    return c0;
}

__attribute__((target("sse4.2")))
uint32_t ceph_tpu_crc32c_hw(uint32_t crc, const uint8_t *buf, size_t len) {
    uint32_t c = ~crc;
    while (len && ((uintptr_t)buf & 7)) {
        c = _mm_crc32_u8(c, *buf++);
        len--;
    }
    uint64_t c0 = c;
    c0 = rounds3(c0, &buf, &len, LONG_BLOCK, shift_long);
    c0 = rounds3(c0, &buf, &len, SHORT_BLOCK, shift_short);
    while (len >= 8) {
        c0 = _mm_crc32_u64(c0, load64(buf));
        buf += 8;
        len -= 8;
    }
    c = (uint32_t)c0;
    while (len--)
        c = _mm_crc32_u8(c, *buf++);
    return ~c;
}

static const char *choose_hw(crc_fn *fn) {
    __builtin_cpu_init();
    if (!__builtin_cpu_supports("sse4.2"))
        return NULL;
    init_shift(shift_long, LONG_BLOCK);
    init_shift(shift_short, SHORT_BLOCK);
    *fn = ceph_tpu_crc32c_hw;
    return "sse4.2-3way";
}

#elif defined(__aarch64__)

#if defined(__clang__)
#define CRC_TARGET __attribute__((target("crc")))
#else
#define CRC_TARGET __attribute__((target("+crc")))
#endif

#ifndef HWCAP_CRC32
#define HWCAP_CRC32 (1 << 7)
#endif

CRC_TARGET
uint32_t ceph_tpu_crc32c_hw(uint32_t crc, const uint8_t *buf, size_t len) {
    uint32_t c = ~crc;
    while (len && ((uintptr_t)buf & 7)) {
        c = __crc32cb(c, *buf++);
        len--;
    }
    while (len >= 8) {
        c = __crc32cd(c, load64(buf));
        buf += 8;
        len -= 8;
    }
    while (len--)
        c = __crc32cb(c, *buf++);
    return ~c;
}

static const char *choose_hw(crc_fn *fn) {
    if (!(getauxval(AT_HWCAP) & HWCAP_CRC32))
        return NULL;
    *fn = ceph_tpu_crc32c_hw;
    return "armv8-crc";
}

#else

static const char *choose_hw(crc_fn *fn) {
    (void)fn;
    return NULL;
}

#endif

static crc_fn chosen = ceph_tpu_crc32c_table;
static const char *chosen_path = "table";
static uint64_t hw_bytes, table_bytes, calls;

__attribute__((constructor))
static void choose(void) {
    init_tables();
    const char *path = choose_hw(&chosen);
    if (path)
        chosen_path = path;
}

uint32_t ceph_tpu_crc32c(uint32_t crc, const uint8_t *buf, size_t len) {
    __atomic_fetch_add(&calls, 1, __ATOMIC_RELAXED);
    __atomic_fetch_add(chosen == ceph_tpu_crc32c_table ? &table_bytes
                                                       : &hw_bytes,
                       (uint64_t)len, __ATOMIC_RELAXED);
    return chosen(crc, buf, len);
}

const char *ceph_tpu_crc32c_path(void) {
    return chosen_path;
}

/* out: hardware bytes, table bytes, calls, since the library loaded. */
void ceph_tpu_crc32c_stats(uint64_t out[3]) {
    out[0] = __atomic_load_n(&hw_bytes, __ATOMIC_RELAXED);
    out[1] = __atomic_load_n(&table_bytes, __ATOMIC_RELAXED);
    out[2] = __atomic_load_n(&calls, __ATOMIC_RELAXED);
}
