// The dense staging route's two device programs: the unpack of a window's
// dense upload into the resident seq and qual matrices, and the overlap
// score map over those matrices. A window stages dense when its reads are
// longer than 256 bases (sparse edit positions are one byte), when its
// sparse staging would need more than 65,535 dense plus genome rows (u16
// row sources), or under GENCORE_NO_SPARSE_UP.
//
// gc_upload_unpack replaces gencore_tpu/engine.py:2883 _upload_unpack_fn
// (K12, a jitted XLA program; its twin is engine._upload_unpack_plain).
// Row r of n, position j < L, every byte exact:
//   * seq: 2-bit rows give 1 << code, four codes per byte, high bits
//     first; 4-bit rows give the BAM nibble, high first;
//   * qual: 2-bit and 4-bit indices decode through qtable[1..3] and
//     qtable[1..15], index 0 giving 0; raw bytes copy through;
//   * zero at and beyond lens[r] and from column w on; lens copied out.
//
// gc_score_map replaces gencore_tpu/core/kernels.py:310 score_map_kernel
// and :373 score_map_kernel_packed (K5, XLA programs; twins
// kernels.score_map_plain and kernels.score_map_packed_plain), which the
// dense route runs after the unpack. Row r takes its mate row mate[r]
// (clamped to [0, N)) and its geometry: packed, meta[r] = my_start 8b |
// mate_start 8b | cmp_len 9b | is_left bit 25 | scored bit 26 with the
// length my_len[r]; else seven int32/byte arrays. Position j of the
// overlap (my_start <= j < my_start + cmp_len, j < my_len; cmp_len may be
// negative) meets the mate's column (j + mate_start - my_start) mod L,
// taken non-negative: a match scores q2s((q + pq) / 2) + 4, a mismatch
// q2s(q - pq) - 3 for the row that wins (q > pq, the left mate winning
// ties) and 0 for the other, and the row's qual becomes max(q - pq, 0);
// elsewhere q2s(q); unscored rows score s_mod and keep their quals. The
// score's int32 wraps to int8 as a cast does. The outputs are buffers of
// their own: a row reads its mate's original quals.
//
// Bound: bytes. Both kernels do a few integer operations per position
// against 2-4 bytes moved per position (the unpack: 0.5-1.25 bytes of
// staging read, two rows of bytes written; the score map: seq and qual
// read, score and qual written, the mate's bytes an L1/L2 hit where they
// overlap). Design: a thread per 16 positions of a row, consecutive
// threads on consecutive chunks of a row, so each output leaves as one
// 16-byte store per thread and the own-row reads of the score map are
// 16-byte loads; the unpack reads its packed bytes and the score map its
// mate's bytes (only inside the overlap) one at a time. No 256 cap on w
// or L: the engine's widths are w a multiple of 8 and L a multiple of 32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // positions per thread

// gc_upload_unpack's mode bits
constexpr int kSeq2 = 1;   // 2-bit seq (else 4-bit nibbles)
constexpr int kQual2 = 2;  // 2-bit qual indices
constexpr int kQual4 = 4;  // 4-bit qual indices (neither: raw bytes)

union Chunk {
  uint4 v;
  uint8_t b[kChunk];
};

__device__ __forceinline__ int crumb(const uint8_t* row, int j) {
  return (row[j >> 2] >> (6 - 2 * (j & 3))) & 3;
}

__device__ __forceinline__ int nibble(const uint8_t* row, int j) {
  const int b = row[j >> 1];
  return (j & 1) ? (b & 15) : (b >> 4);
}

__global__ void __launch_bounds__(kThreads)
    upload_unpack_kernel(const uint8_t* __restrict__ seq_up, const uint8_t* __restrict__ qual_up,
                         const int32_t* __restrict__ lens, const uint8_t* __restrict__ qtable,
                         uint8_t* __restrict__ seq, uint8_t* __restrict__ qual,
                         int32_t* __restrict__ lens_out, int n, int w, int L, int sw, int qw,
                         int modes) {
  __shared__ uint8_t qt[16];
  if (threadIdx.x < 16)
    qt[threadIdx.x] =
        (threadIdx.x > 0 && (modes & (kQual2 | kQual4))) ? qtable[threadIdx.x] : 0;
  __syncthreads();
  const int C = L / kChunk;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * C) return;
  const int r = static_cast<int>(t / C);
  const int j0 = static_cast<int>(t - static_cast<long long>(r) * C) * kChunk;
  const int len = lens[r];
  const int lim = len < w ? len : w;
  if (j0 == 0) lens_out[r] = len;
  const uint8_t* srow = seq_up + static_cast<size_t>(r) * sw;
  const uint8_t* qrow = qual_up + static_cast<size_t>(r) * qw;
  Chunk s, q;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int j = j0 + k;
    int sv = 0, qv = 0;
    if (j < lim) {
      sv = (modes & kSeq2) ? (1 << crumb(srow, j)) : nibble(srow, j);
      qv = (modes & kQual2) ? qt[crumb(qrow, j)]
                            : ((modes & kQual4) ? qt[nibble(qrow, j)] : qrow[j]);
    }
    s.b[k] = static_cast<uint8_t>(sv);
    q.b[k] = static_cast<uint8_t>(qv);
  }
  const size_t o = static_cast<size_t>(r) * L + j0;
  *reinterpret_cast<uint4*>(seq + o) = s.v;
  *reinterpret_cast<uint4*>(qual + o) = q.v;
}

struct Tiers {
  int hi, mod, lo, s_hi, s_mod, s_lo, s_bad;
};

// pair.cpp:77-86: the last tier the value reaches
__device__ __forceinline__ int q2s(int x, const Tiers& t) {
  return x >= t.hi ? t.s_hi : (x >= t.mod ? t.s_mod : (x >= t.lo ? t.s_lo : t.s_bad));
}

struct Geometry {
  const int32_t* mate;
  const int32_t* meta;        // packed form
  const int32_t* my_start;    // int32 form, with the next four
  const int32_t* mate_start;
  const int32_t* cmp_len;
  const uint8_t* is_left;
  const uint8_t* scored;
  const int32_t* my_len;      // both forms
};

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
    score_map_kernel(const uint8_t* __restrict__ seq, const uint8_t* __restrict__ qual,
                     const Geometry g, uint8_t* __restrict__ score,
                     uint8_t* __restrict__ qual_out, int N, int L, const Tiers tiers) {
  const int C = L / kChunk;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(N) * C) return;
  const int r = static_cast<int>(t / C);
  const int j0 = static_cast<int>(t - static_cast<long long>(r) * C) * kChunk;
  const size_t o = static_cast<size_t>(r) * L + j0;
  Chunk q, s, sc, qo;
  q.v = *reinterpret_cast<const uint4*>(qual + o);
  int ms, ts, cl;
  bool left, scored;
  if (kPacked) {
    const uint32_t m = static_cast<uint32_t>(g.meta[r]);
    ms = m & 0xFF;
    ts = (m >> 8) & 0xFF;
    cl = (m >> 16) & 0x1FF;
    left = (m >> 25) & 1;
    scored = (m >> 26) & 1;
  } else {
    ms = g.my_start[r];
    ts = g.mate_start[r];
    cl = g.cmp_len[r];
    left = g.is_left[r] != 0;
    scored = g.scored[r] != 0;
  }
  if (!scored) {
    const uint32_t b = static_cast<uint8_t>(tiers.s_mod) * 0x01010101u;
    sc.v = make_uint4(b, b, b, b);
    *reinterpret_cast<uint4*>(score + o) = sc.v;
    *reinterpret_cast<uint4*>(qual_out + o) = q.v;
    return;
  }
  s.v = *reinterpret_cast<const uint4*>(seq + o);
  const int ml = g.my_len[r];
  int mr = g.mate[r];
  mr = mr < 0 ? 0 : (mr > N - 1 ? N - 1 : mr);
  // int32 arithmetic that wraps, as the twin's int32 tensors do
  int d = static_cast<int>(static_cast<uint32_t>(ts) - static_cast<uint32_t>(ms)) % L;
  if (d < 0) d += L;
  const int end = static_cast<int>(static_cast<uint32_t>(ms) + static_cast<uint32_t>(cl));
  const uint8_t* pseq = seq + static_cast<size_t>(mr) * L;
  const uint8_t* pqual = qual + static_cast<size_t>(mr) * L;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int j = j0 + k;
    const int qi = q.b[k];
    int sv, qn = qi;
    if (j >= ms && j < end && j < ml) {
      int idx = j + d;
      if (idx >= L) idx -= L;
      const int pq = pqual[idx];
      if (s.b[k] == pseq[idx]) {
        sv = q2s((qi + pq) >> 1, tiers) + 4;
      } else {
        const bool win = qi > pq || (left && qi == pq);
        sv = win ? q2s(qi - pq, tiers) - 3 : 0;
        qn = qi > pq ? qi - pq : 0;
      }
    } else {
      sv = q2s(qi, tiers);
    }
    sc.b[k] = static_cast<uint8_t>(sv);
    qo.b[k] = static_cast<uint8_t>(qn);
  }
  *reinterpret_cast<uint4*>(score + o) = sc.v;
  *reinterpret_cast<uint4*>(qual_out + o) = qo.v;
}

bool misaligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) != 0;
}

int blocks_for(int rows, int L, cudaError_t* e) {
  const long long total = static_cast<long long>(rows) * (L / kChunk);
  const long long b = (total + kThreads - 1) / kThreads;
  *e = b > 0x7FFFFFFF ? cudaErrorInvalidValue : cudaSuccess;
  return static_cast<int>(b);
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = success). seq_up u8
// [n, sw], qual_up u8 [n, qw], lens i32 [n], qtable u8 [16] (read only
// with 2- or 4-bit quals); outputs seq, qual u8 [n, L] (16-byte aligned,
// L % 16 == 0) and lens_out i32 [n]. modes: 1 2-bit seq (else 4-bit), 2
// 2-bit qual, 4 4-bit qual (neither: raw, qw >= w).
extern "C" int gc_upload_unpack(const void* seq_up, const void* qual_up, const void* lens,
                                const void* qtable, void* seq, void* qual, void* lens_out, int n,
                                int w, int L, int sw, int qw, int modes, void* stream) {
  if (n <= 0) return 0;
  const int seq_per_byte = (modes & kSeq2) ? 4 : 2;
  const int qual_per_byte = (modes & kQual2) ? 4 : ((modes & kQual4) ? 2 : 1);
  if (w <= 0 || L < w || L % kChunk != 0 || seq_per_byte * static_cast<long long>(sw) < w ||
      qual_per_byte * static_cast<long long>(qw) < w || ((modes & kQual2) && (modes & kQual4)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(seq, qual)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t e;
  const int grid = blocks_for(n, L, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  upload_unpack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq_up), static_cast<const uint8_t*>(qual_up),
      static_cast<const int32_t*>(lens), static_cast<const uint8_t*>(qtable),
      static_cast<uint8_t*>(seq), static_cast<uint8_t*>(qual), static_cast<int32_t*>(lens_out),
      n, w, L, sw, qw, modes);
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns a cudaError_t (0 = success). seq, qual u8
// [N, L] (16-byte aligned, L % 16 == 0); mate i32 [N]; packed: meta i32
// [N] (the u32 bits) and my_len i32 [N], the int32 form's arrays null;
// else my_start, mate_start, cmp_len, my_len i32 [N] and is_left, scored
// u8 [N] (0 or not), meta null. Outputs score i8 and qual_out u8 [N, L],
// 16-byte aligned, aliasing no input. ints: N, L, packed, hi, mod, lo,
// s_hi, s_mod, s_lo, s_bad.
extern "C" int gc_score_map(const void* seq, const void* qual, const void* mate,
                            const void* meta, const void* my_start, const void* mate_start,
                            const void* cmp_len, const void* my_len, const void* is_left,
                            const void* scored, void* score, void* qual_out, int N, int L,
                            int packed, int hi, int mod, int lo, int s_hi, int s_mod, int s_lo,
                            int s_bad, void* stream) {
  if (N <= 0) return 0;
  if (L <= 0 || L % kChunk != 0 || mate == nullptr || my_len == nullptr ||
      (packed ? meta == nullptr
              : (my_start == nullptr || mate_start == nullptr || cmp_len == nullptr ||
                 is_left == nullptr || scored == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(seq, qual) || misaligned(score, qual_out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t e;
  const int grid = blocks_for(N, L, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  Geometry g;
  g.mate = static_cast<const int32_t*>(mate);
  g.meta = static_cast<const int32_t*>(meta);
  g.my_start = static_cast<const int32_t*>(my_start);
  g.mate_start = static_cast<const int32_t*>(mate_start);
  g.cmp_len = static_cast<const int32_t*>(cmp_len);
  g.is_left = static_cast<const uint8_t*>(is_left);
  g.scored = static_cast<const uint8_t*>(scored);
  g.my_len = static_cast<const int32_t*>(my_len);
  const Tiers tiers{hi, mod, lo, s_hi, s_mod, s_lo, s_bad};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* s8 = static_cast<const uint8_t*>(seq);
  const uint8_t* q8 = static_cast<const uint8_t*>(qual);
  if (packed)
    score_map_kernel<true><<<grid, kThreads, 0, st>>>(s8, q8, g, static_cast<uint8_t*>(score),
                                                      static_cast<uint8_t*>(qual_out), N, L,
                                                      tiers);
  else
    score_map_kernel<false><<<grid, kThreads, 0, st>>>(s8, q8, g, static_cast<uint8_t*>(score),
                                                       static_cast<uint8_t*>(qual_out), N, L,
                                                       tiers);
  return static_cast<int>(cudaGetLastError());
}
