// wal_engine — native durability tier for the WalStore.
//
// The role of reference src/os/bluestore's write path core
// (BlueStore.cc queue_transactions -> deferred WAL -> kv commit, and
// BlueFS's log-structured metadata): framed, crc32c-protected
// write-ahead-log appends, torn-tail-tolerant replay, and atomic
// checkpoint replacement — the fsync-discipline/file-integrity layer —
// implemented in C++ behind a C ABI the Python layer loads via ctypes.
// The on-disk format is IDENTICAL to the pure-Python WalStore
// (walstore.py): magic line, then frames of <u32 len><u32 crc32c>
// little-endian + payload; checkpoints are magic + one frame.  Either
// implementation can replay the other's files.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

extern "C" uint32_t ceph_tpu_crc32c(uint32_t crc, const char *buf,
                                    size_t len);

namespace {

const char WAL_MAGIC[] = "ceph-tpu-wal-1\n";
const char CKPT_MAGIC[] = "ceph-tpu-ckpt-1\n";
const size_t WAL_MAGIC_LEN = sizeof(WAL_MAGIC) - 1;
const size_t CKPT_MAGIC_LEN = sizeof(CKPT_MAGIC) - 1;

struct Handle {
  FILE *f = nullptr;
  std::string path;
  int sync = 0;
};

void put_u32(uint8_t *p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}

uint32_t get_u32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

int flush_handle(Handle *h) {
  if (!h->f) return -1;
  if (fflush(h->f) != 0) return -1;
  if (h->sync && fsync(fileno(h->f)) != 0) return -1;
  return 0;
}

bool read_file(const std::string &path, std::vector<uint8_t> &out) {
  FILE *f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n < 0) {
    fclose(f);
    return false;
  }
  fseek(f, 0, SEEK_SET);
  out.resize((size_t)n);
  size_t got = n ? fread(out.data(), 1, (size_t)n, f) : 0;
  fclose(f);
  return got == (size_t)n;
}

}  // namespace

extern "C" {

// Open (append mode) a WAL file; writes the magic when empty.
// Returns an opaque handle or null.
void *we_open(const char *path, int sync) {
  Handle *h = new Handle;
  h->path = path;
  h->sync = sync;
  h->f = fopen(path, "ab");
  if (!h->f) {
    delete h;
    return nullptr;
  }
  if (ftell(h->f) == 0) {
    fwrite(WAL_MAGIC, 1, WAL_MAGIC_LEN, h->f);
    if (flush_handle(h) != 0) {
      fclose(h->f);
      delete h;
      return nullptr;
    }
  }
  return h;
}

// Append one framed record; returns the WAL size after the append
// (the checkpoint-threshold input) or -1 on error.
long we_append(void *hv, const uint8_t *payload, size_t len) {
  Handle *h = (Handle *)hv;
  if (!h->f) return -1;
  uint8_t hdr[8];
  put_u32(hdr, (uint32_t)len);
  put_u32(hdr + 4,
          ceph_tpu_crc32c(0xFFFFFFFFu, (const char *)payload, len));
  if (fwrite(hdr, 1, 8, h->f) != 8) return -1;
  if (len && fwrite(payload, 1, len, h->f) != len) return -1;
  if (flush_handle(h) != 0) return -1;
  long pos = ftell(h->f);
  return pos;
}

// Truncate the WAL back to just its magic (post-checkpoint reset).
int we_reset(void *hv) {
  Handle *h = (Handle *)hv;
  // Reopen into a temp FILE* first so a failed fopen leaves the old
  // handle usable instead of a NULL f that later appends dereference.
  FILE *nf = fopen(h->path.c_str(), "wb");
  if (!nf) return -1;
  if (h->f) fclose(h->f);
  h->f = nf;
  fwrite(WAL_MAGIC, 1, WAL_MAGIC_LEN, h->f);
  return flush_handle(h);
}

int we_close(void *hv) {
  Handle *h = (Handle *)hv;
  int rc = h->f ? fclose(h->f) : 0;
  delete h;
  return rc;
}

// Scan a WAL: validate frames, truncate any torn tail in place, and
// return the valid payloads as one buffer of [u32 len][payload] entries.
// Caller frees with we_free.  Returns 0 ok (even when empty), -1 error.
int we_replay(const char *path, uint8_t **out, size_t *out_len) {
  *out = nullptr;
  *out_len = 0;
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return 0;  // absent file: nothing to replay
  size_t pos = 0;
  if (raw.size() >= WAL_MAGIC_LEN &&
      memcmp(raw.data(), WAL_MAGIC, WAL_MAGIC_LEN) == 0)
    pos = WAL_MAGIC_LEN;
  size_t good = pos;
  std::vector<uint8_t> acc;
  while (pos + 8 <= raw.size()) {
    uint32_t len = get_u32(raw.data() + pos);
    uint32_t crc = get_u32(raw.data() + pos + 4);
    size_t start = pos + 8, end = start + len;
    if (end > raw.size()) break;  // torn tail
    if (ceph_tpu_crc32c(0xFFFFFFFFu, (const char *)raw.data() + start,
                        len) != crc)
      break;
    uint8_t lenbuf[4];
    put_u32(lenbuf, len);
    acc.insert(acc.end(), lenbuf, lenbuf + 4);
    acc.insert(acc.end(), raw.begin() + start, raw.begin() + end);
    good = end;
    pos = end;
  }
  if (good < raw.size()) {
    if (truncate(path, (off_t)good) != 0) return -1;
  }
  if (!acc.empty()) {
    *out = (uint8_t *)malloc(acc.size());
    if (!*out) return -1;
    memcpy(*out, acc.data(), acc.size());
    *out_len = acc.size();
  }
  return 0;
}

// Write a checkpoint atomically: tmp file, magic + frame, fsync, rename.
int we_write_checkpoint(const char *path, const uint8_t *blob,
                        size_t len) {
  std::string tmp = std::string(path) + ".tmp";
  FILE *f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  uint8_t hdr[8];
  put_u32(hdr, (uint32_t)len);
  put_u32(hdr + 4, ceph_tpu_crc32c(0xFFFFFFFFu, (const char *)blob, len));
  bool ok = fwrite(CKPT_MAGIC, 1, CKPT_MAGIC_LEN, f) == CKPT_MAGIC_LEN &&
            fwrite(hdr, 1, 8, f) == 8 &&
            (len == 0 || fwrite(blob, 1, len, f) == len) &&
            fflush(f) == 0 && fsync(fileno(f)) == 0;
  ok = (fclose(f) == 0) && ok;
  if (!ok) {
    unlink(tmp.c_str());
    return -1;
  }
  if (rename(tmp.c_str(), path) != 0) return -1;
  return 0;
}

// Read + validate a checkpoint; returns the blob (we_free) or rc!=0:
// 1 = absent/invalid (caller falls back to WAL-only replay), -1 = error.
int we_read_checkpoint(const char *path, uint8_t **out, size_t *out_len) {
  *out = nullptr;
  *out_len = 0;
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return 1;
  if (raw.size() < CKPT_MAGIC_LEN + 8 ||
      memcmp(raw.data(), CKPT_MAGIC, CKPT_MAGIC_LEN) != 0)
    return 1;
  const uint8_t *body = raw.data() + CKPT_MAGIC_LEN;
  uint32_t len = get_u32(body);
  uint32_t crc = get_u32(body + 4);
  if (CKPT_MAGIC_LEN + 8 + (size_t)len > raw.size()) return 1;
  if (ceph_tpu_crc32c(0xFFFFFFFFu, (const char *)body + 8, len) != crc)
    return 1;
  *out = (uint8_t *)malloc(len ? len : 1);
  if (!*out) return -1;
  memcpy(*out, body + 8, len);
  *out_len = len;
  return 0;
}

void we_free(void *p) { free(p); }

}  // extern "C"
