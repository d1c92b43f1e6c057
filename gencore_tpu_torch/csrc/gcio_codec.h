// Raw-DEFLATE codec behind the BGZF entry points of gcio.cpp: one small
// interface with two implementations chosen at compile time.
//
//   -DGCIO_CODEC_LIBDEFLATE   libdeflate (link -ldeflate)
//   -DGCIO_CODEC_ZLIB         zlib       (link -lz)
//
// With neither defined, libdeflate is taken where <libdeflate.h> is
// found, else zlib. Both produce and accept the same format (RFC 1951
// streams inside BGZF blocks, CRC-32 of the plain bytes); the compressed
// bytes differ between the two, the decoded bytes never do.
//
// An Inflater/Deflater belongs to one thread; each worker of gcio.cpp
// makes its own.

#pragma once

#include <cstddef>
#include <cstdint>

#if !defined(GCIO_CODEC_LIBDEFLATE) && !defined(GCIO_CODEC_ZLIB)
#if __has_include(<libdeflate.h>)
#define GCIO_CODEC_LIBDEFLATE 1
#else
#define GCIO_CODEC_ZLIB 1
#endif
#endif

#if defined(GCIO_CODEC_LIBDEFLATE)

#include <libdeflate.h>

namespace gcio {

inline const char* codec_name() { return "libdeflate"; }

class Inflater {
 public:
  Inflater() : d_(libdeflate_alloc_decompressor()) {}
  ~Inflater() { if (d_) libdeflate_free_decompressor(d_); }
  Inflater(const Inflater&) = delete;
  Inflater& operator=(const Inflater&) = delete;
  // Inflate one whole raw-DEFLATE stream into exactly out_len bytes.
  bool inflate(const uint8_t* in, size_t in_len, uint8_t* out,
               size_t out_len) {
    if (!d_) return false;
    size_t actual = 0;
    auto r = libdeflate_deflate_decompress(d_, in, in_len, out, out_len,
                                           &actual);
    return r == LIBDEFLATE_SUCCESS && actual == out_len;
  }

 private:
  libdeflate_decompressor* d_;
};

class Deflater {
 public:
  explicit Deflater(int level) : c_(libdeflate_alloc_compressor(level)) {}
  ~Deflater() { if (c_) libdeflate_free_compressor(c_); }
  Deflater(const Deflater&) = delete;
  Deflater& operator=(const Deflater&) = delete;
  size_t bound(size_t n) {
    return c_ ? libdeflate_deflate_compress_bound(c_, n) : 0;
  }
  // Deflate in[0:n) as one finished raw stream; 0 on failure.
  size_t deflate(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
    return c_ ? libdeflate_deflate_compress(c_, in, n, out, cap) : 0;
  }

 private:
  libdeflate_compressor* c_;
};

inline uint32_t crc32(const uint8_t* p, size_t n) {
  return libdeflate_crc32(0, p, n);
}

}  // namespace gcio

#else  // GCIO_CODEC_ZLIB

#include <zlib.h>

#include <cstring>

namespace gcio {

inline const char* codec_name() { return "zlib"; }

class Inflater {
 public:
  Inflater() {
    memset(&z_, 0, sizeof(z_));
    ok_ = inflateInit2(&z_, -15) == Z_OK;
  }
  ~Inflater() { if (ok_) inflateEnd(&z_); }
  Inflater(const Inflater&) = delete;
  Inflater& operator=(const Inflater&) = delete;
  bool inflate(const uint8_t* in, size_t in_len, uint8_t* out,
               size_t out_len) {
    if (!ok_ || inflateReset(&z_) != Z_OK) return false;
    z_.next_in = const_cast<Bytef*>(in);
    z_.avail_in = static_cast<uInt>(in_len);
    z_.next_out = out;
    z_.avail_out = static_cast<uInt>(out_len);
    int r = ::inflate(&z_, Z_FINISH);
    return r == Z_STREAM_END && z_.avail_out == 0;
  }

 private:
  z_stream z_;
  bool ok_;
};

class Deflater {
 public:
  // zlib's levels end at 9; libdeflate's 10-12 map onto it.
  explicit Deflater(int level) {
    memset(&z_, 0, sizeof(z_));
    if (level > 9) level = 9;
    if (level < 0) level = Z_DEFAULT_COMPRESSION;
    ok_ = deflateInit2(&z_, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) == Z_OK;
  }
  ~Deflater() { if (ok_) deflateEnd(&z_); }
  Deflater(const Deflater&) = delete;
  Deflater& operator=(const Deflater&) = delete;
  size_t bound(size_t n) {
    return ok_ ? static_cast<size_t>(deflateBound(&z_, static_cast<uLong>(n)))
               : 0;
  }
  size_t deflate(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
    if (!ok_ || deflateReset(&z_) != Z_OK) return 0;
    z_.next_in = const_cast<Bytef*>(in);
    z_.avail_in = static_cast<uInt>(n);
    z_.next_out = out;
    z_.avail_out = static_cast<uInt>(cap);
    int r = ::deflate(&z_, Z_FINISH);
    return r == Z_STREAM_END ? cap - z_.avail_out : 0;
  }

 private:
  z_stream z_;
  bool ok_;
};

inline uint32_t crc32(const uint8_t* p, size_t n) {
  return static_cast<uint32_t>(::crc32(0L, p, static_cast<uInt>(n)));
}

}  // namespace gcio

#endif
