// Standalone exerciser for the port's threaded native core (gcio.cpp
// behind the codec shim gcio_codec.h), built with -fsanitize=thread once
// per codec (-DGCIO_CODEC_ZLIB -lz or -DGCIO_CODEC_LIBDEFLATE -ldeflate) so
// that the BGZF inflate/deflate workers, each with its own Inflater or
// Deflater, the row gathers and the nibble packers run under TSan.
// tests/test_torch_native.py and chip_smoke.py build and run it through
// gencore_tpu_torch/io/native.py's build_tsan().
//
// Usage: test_gcio <tmpdir>   - exits non-zero on any failure; TSan
// reports (if any) go to stderr and fail the caller.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
const char* gc_codec_name();
uint8_t* gc_bgzf_read(const char* path, int64_t* out_len, int n_threads);
int gc_bgzf_write(const char* path, const uint8_t* payload, int64_t len,
                  int level, int n_threads);
int gc_bgzf_write_ex(const char* path, const uint8_t* payload, int64_t len,
                     int level, int n_threads, int append, int write_eof);
int gc_bgzf_read_blocks(const char* path, int64_t block_lo, int64_t block_hi,
                        uint8_t* out, int64_t out_cap, int n_threads);
int gc_bgzf_read_span(const char* path, int64_t file_lo, int64_t file_hi,
                      uint8_t* out, int64_t out_cap, int n_threads);
int64_t gc_bgzf_block_table(const char* path, int64_t* table, int64_t cap,
                            int64_t* total_out);
void gc_gather_slices(const uint8_t* src, const int64_t* src_off,
                      const int64_t* src_len, int64_t n, uint8_t* dst,
                      const int64_t* dst_off, int n_threads);
void gc_unpack_seq_rows(const uint8_t* src, const int64_t* src_off,
                        const int32_t* lens, int64_t n, uint8_t* out,
                        int64_t L, int n_threads);
void gc_copy_rows(const uint8_t* src, const int64_t* src_off,
                  const int32_t* lens, int64_t n, uint8_t* out, int64_t L,
                  int n_threads);
void gc_pack_seq_rows(const uint8_t* rows, int64_t L, const int32_t* lens,
                      int64_t n, uint8_t* dst, const int64_t* dst_off,
                      int n_threads);
void gc_pack_nib_rows(const uint8_t* src, const int64_t* src_off,
                      const int32_t* lens, int64_t n, const uint8_t* lut,
                      uint8_t* out, int64_t pw, int n_threads);
void gc_unpack_nib_dense(const uint8_t* src, int64_t n, int64_t pw,
                         const uint8_t* lut, uint8_t* out, int n_threads);
void gc_free(void* p);
}

static uint32_t rng_state = 12345;
static uint32_t rnd() {
  rng_state = rng_state * 1664525u + 1013904223u;
  return rng_state;
}

#define CHECK(cond)                                                      \
  do {                                                                   \
    if (!(cond)) {                                                       \
      fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__, __LINE__, \
              #cond);                                                    \
      return 1;                                                          \
    }                                                                    \
  } while (0)

int main(int argc, char** argv) {
  std::string dir = argc > 1 ? argv[1] : "/tmp";
  std::string path = dir + "/tsan_test.bgzf";

  // threaded deflate + inflate round trip (several MB, many blocks)
  std::vector<uint8_t> payload(3 << 20);
  for (auto& b : payload) b = rnd() & 0xFF;
  CHECK(gc_bgzf_write(path.c_str(), payload.data(), payload.size(), 4, 8) == 0);
  int64_t n = 0;
  uint8_t* got = gc_bgzf_read(path.c_str(), &n, 8);
  CHECK(got && n == (int64_t)payload.size());
  CHECK(memcmp(got, payload.data(), n) == 0);
  gc_free(got);

  // block table + ranged decode, concurrent-ish sequential calls
  int64_t table[4096 * 2];
  int64_t total = 0;
  int64_t nb = gc_bgzf_block_table(path.c_str(), table, 4096, &total);
  CHECK(nb > 1 && total == (int64_t)payload.size());
  std::vector<uint8_t> half(total);
  CHECK(gc_bgzf_read_blocks(path.c_str(), 0, nb, half.data(), total, 8) == 0);
  CHECK(memcmp(half.data(), payload.data(), total) == 0);

  // ranged decode that reads only its span: the second half of the blocks
  int64_t mid = nb / 2;
  int64_t span_len = total - table[2 * mid + 1];
  std::vector<uint8_t> span(span_len);
  int64_t file_end = 0;
  {
    FILE* f = fopen(path.c_str(), "rb");
    CHECK(f && fseek(f, 0, SEEK_END) == 0);
    file_end = ftell(f);
    fclose(f);
  }
  CHECK(gc_bgzf_read_span(path.c_str(), table[2 * mid], file_end,
                          span.data(), span_len, 8) == 0);
  CHECK(memcmp(span.data(), payload.data() + table[2 * mid + 1],
               span_len) == 0);

  // two callers at once, each with its own worker threads and codec
  // state: one inflates the file while the other deflates a second one
  std::string path2 = dir + "/tsan_test2.bgzf";
  int rc_w = -1;
  uint8_t* got2 = nullptr;
  int64_t n2 = 0;
  std::thread writer([&]() {
    rc_w = gc_bgzf_write(path2.c_str(), payload.data(), payload.size(), 6, 4);
  });
  std::thread reader([&]() { got2 = gc_bgzf_read(path.c_str(), &n2, 4); });
  writer.join();
  reader.join();
  CHECK(rc_w == 0 && got2 && n2 == (int64_t)payload.size());
  CHECK(memcmp(got2, payload.data(), n2) == 0);
  gc_free(got2);
  got2 = gc_bgzf_read(path2.c_str(), &n2, 8);
  CHECK(got2 && n2 == (int64_t)payload.size());
  CHECK(memcmp(got2, payload.data(), n2) == 0);
  gc_free(got2);

  // append mode
  CHECK(gc_bgzf_write_ex(path.c_str(), payload.data(), 1000, 4, 8, 0, 0) == 0);
  CHECK(gc_bgzf_write_ex(path.c_str(), payload.data() + 1000, 1000, 4, 8, 1,
                         1) == 0);
  got = gc_bgzf_read(path.c_str(), &n, 8);
  CHECK(got && n == 2000 && memcmp(got, payload.data(), 2000) == 0);
  gc_free(got);

  // row machinery on ragged layouts
  const int64_t R = 5000, L = 151;
  std::vector<int64_t> off(R), dst_off(R);
  std::vector<int32_t> lens(R);
  int64_t pos = 0;
  for (int64_t i = 0; i < R; ++i) {
    lens[i] = 1 + (rnd() % L);
    off[i] = pos;
    pos += lens[i];
  }
  std::vector<uint8_t> src(pos);
  for (auto& b : src) b = rnd() & 0xF;
  std::vector<uint8_t> rows(R * L), rows2(R * L);
  gc_copy_rows(src.data(), off.data(), lens.data(), R, rows.data(), L, 8);
  for (int64_t i = 0; i < 64; ++i) {
    int64_t r = rnd() % R;
    CHECK(rows[r * L] == src[off[r]]);
  }
  gc_unpack_seq_rows(src.data(), off.data(), lens.data(), R, rows2.data(), L,
                     8);
  // pack back and compare the packed bytes
  std::vector<uint8_t> packed(pos);
  int64_t ppos = 0;
  std::vector<int64_t> poff(R);
  for (int64_t i = 0; i < R; ++i) {
    poff[i] = ppos;
    ppos += (lens[i] + 1) / 2;
  }
  packed.resize(ppos);
  gc_pack_seq_rows(rows2.data(), L, lens.data(), R, packed.data(),
                   poff.data(), 8);
  uint8_t lut[16];
  for (int i = 0; i < 16; ++i) lut[i] = (uint8_t)(i * 3);
  std::vector<uint8_t> nib(R * 80), dense(R * 160);
  std::vector<int32_t> lens2(R);
  for (int64_t i = 0; i < R; ++i) lens2[i] = lens[i] > 160 ? 160 : lens[i];
  gc_pack_nib_rows(src.data(), off.data(), lens2.data(), R, lut, nib.data(),
                   80, 8);
  gc_unpack_nib_dense(nib.data(), R, 80, lut, dense.data(), 8);

  // gather_slices
  std::vector<uint8_t> gdst(pos);
  std::vector<int64_t> glen(R);
  int64_t gpos = 0;
  std::vector<int64_t> gdo(R);
  for (int64_t i = 0; i < R; ++i) {
    glen[i] = lens[i];
    gdo[i] = gpos;
    gpos += glen[i];
  }
  gc_gather_slices(src.data(), off.data(), glen.data(), R, gdst.data(),
                   gdo.data(), 8);
  CHECK(memcmp(gdst.data(), src.data(), pos) == 0);

  printf("test_gcio OK (%s)\n", gc_codec_name());
  return 0;
}
