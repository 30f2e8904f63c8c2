// Native IDX (MNIST distribution format) reader, exposed to Python via
// ctypes (distributedmnist_tpu_torch/data/native/__init__.py): the port's
// copy of distributedmnist_tpu/data/native/idx_reader.cpp.
//
// Role: the reference's data path is backed by native code (torch's C++
// DataLoader machinery); this is the framework's native equivalent for the
// host-side IO it actually has. The hot path is the on-device index
// gather (data/loader.py) — host IO happens once at startup, so this
// component optimizes cold-start: a single mmap-free streamed read with no
// intermediate Python objects.
//
// ABI (stable, C):
//   idx_probe(path, out_ndim, out_dims[4])         -> 0 ok | <0 errno-ish
//   idx_read(path, out_buf, buf_len)               -> bytes read | <0 error

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrMagic = -2;
constexpr int kErrTrunc = -3;
constexpr int kErrSmallBuf = -4;

// Big-endian u32 read.
uint32_t be32(const unsigned char *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct Header {
  int ndim;
  uint64_t dims[4];
  uint64_t total;
};

int read_header(FILE *f, Header *h) {
  unsigned char buf[4];
  if (fread(buf, 1, 4, f) != 4) return kErrTrunc;
  uint32_t magic = be32(buf);
  // IDX magic: 0x00 0x00 <dtype> <ndim>; MNIST uses dtype 0x08 (u8).
  if ((magic & 0xFFFF0000u) != 0 || ((magic >> 8) & 0xFF) != 0x08)
    return kErrMagic;
  h->ndim = int(magic & 0xFF);
  if (h->ndim < 1 || h->ndim > 4) return kErrMagic;
  h->total = 1;
  for (int i = 0; i < h->ndim; ++i) {
    if (fread(buf, 1, 4, f) != 4) return kErrTrunc;
    h->dims[i] = be32(buf);
    h->total *= h->dims[i];
  }
  return 0;
}

}  // namespace

extern "C" {

int idx_probe(const char *path, int *out_ndim, uint64_t *out_dims) {
  FILE *f = fopen(path, "rb");
  if (!f) return kErrOpen;
  Header h;
  int rc = read_header(f, &h);
  fclose(f);
  if (rc) return rc;
  *out_ndim = h.ndim;
  for (int i = 0; i < h.ndim; ++i) out_dims[i] = h.dims[i];
  return 0;
}

long long idx_read(const char *path, unsigned char *out, long long cap) {
  FILE *f = fopen(path, "rb");
  if (!f) return kErrOpen;
  Header h;
  int rc = read_header(f, &h);
  if (rc) {
    fclose(f);
    return rc;
  }
  if (uint64_t(cap) < h.total) {
    fclose(f);
    return kErrSmallBuf;
  }
  size_t got = fread(out, 1, h.total, f);
  fclose(f);
  if (got != h.total) return kErrTrunc;
  return (long long)got;
}

}  // extern "C"
