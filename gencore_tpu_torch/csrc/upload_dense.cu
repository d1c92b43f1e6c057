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
// Bound: bytes. Both kernels write two [n, L] byte matrices and read a
// fraction of that (the unpack: 0.5-1.25 bytes of staging per position;
// the score map: qual, and seq only inside the overlaps), with a few
// integer operations per position. The first versions (a thread per 16
// positions, the task's row and column from a 64-bit division, the
// staging and the mate's bytes loaded one byte per position, every scored
// row's mate read again as a row of its own, the geometry loaded by each
// of a row's threads) ran at a third of that bound, at a fixed rate per
// position whatever the shape; a clock64() split of them put 49-79% of a
// thread's cycles in chains of dependent loads, 15-33% (51% packed) in
// the per-position arithmetic and 2-5% in the 64-bit division.
//
// Design (Hopper). Both: a task is 16 positions of one row, so that each
// output leaves as one 16-byte store; tasks of a block are consecutive,
// row and column come from 32-bit arithmetic stepped per task, and every
// input is read in aligned words (a word or granule is loaded only where
// it holds a byte the task needs, so no load leaves the input's 16-byte
// granules) and shifted into place with funnel shifts.
//   * gc_upload_unpack: a thread takes kUnpackTasks tasks a block-stride
//     apart; per task 1-2 (2-bit), 2-3 (4-bit) staging words or 1-2
//     16-byte granules (raw quals), decoded a staging byte at a time
//     through 256-entry tables built in shared memory at block start (a
//     2-bit byte to four output bytes, a 4-bit byte to two, quals through
//     qtable with index 0 giving 0), the length mask applied per word.
//   * gc_score_map: a warp takes a batch of rows (kBatch, or down to
//     kMinBatch where fewer rows than the card's resident warps hold
//     would leave it a short wave of long warps), a lane per row loading
//     the row's geometry once (coalesced). A row whose clamped mate names
//     it back is a mate pair: the warp of the lower row takes both rows,
//     each with its own geometry, flags and original quals, and the
//     higher row's warp skips it; any other row (self, clamped or
//     third-row mates) takes its mate's bytes alone. The batch's output
//     rows go to shared memory as jobs and the warp's lanes walk their
//     (row, chunk) tasks in order, so the two rows of a pair are read by
//     one warp at one time and the mate's granules come from L1. A task
//     loads its qual granule, and only where its chunk meets the overlap
//     its seq granule and the mate's two granules of seq and qual around
//     the shifted column (the wrap at L falls on a granule boundary);
//     four positions per 32-bit word in byte-SIMD: compares from the
//     bytes' biased differences, their masks by prmt's sign replication,
//     the tiers by compares against thresholds clamped to the byte range
//     (a threshold above 255 never reached, one at or below 0 always),
//     the scores' int8 wrap by byte-wise adds. What bounds it now is the
//     walk itself: a pass of the lanes is a round trip to memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;       // positions per task
constexpr int kUnpackTasks = 4;  // unpack tasks per thread
constexpr int kBatch = 16;       // score-map rows per warp batch, at most
constexpr int kMinBatch = 4;     // ... and at least
constexpr unsigned kAll = 0xffffffffu;

// gc_upload_unpack's mode bits
constexpr int kSeq2 = 1;   // 2-bit seq (else 4-bit nibbles)
constexpr int kQual2 = 2;  // 2-bit qual indices
constexpr int kQual4 = 4;  // 4-bit qual indices (neither: raw bytes)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 0xFF in the bytes of a word below byte k (k in [0, 4]).
__device__ __forceinline__ uint32_t below(int k) {
  return ~__funnelshift_lc(0u, kAll, 8 * k);
}

// a where m's bytes are set, else b.
__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

__device__ __forceinline__ uint4 ldg16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Bytes sh..sh+15 of the 32 bytes a:b, as four little-order words.
__device__ __forceinline__ void align16(const uint4 a, const uint4 b, int sh, uint32_t out[4]) {
  const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int wo = sh >> 2;
  uint32_t t[6], s[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) t[i] = (wo & 2) ? v[i + 2] : v[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) s[i] = (wo & 1) ? t[i + 1] : t[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __funnelshift_r(s[i], s[i + 1], 8 * (sh & 3));
}

// The 4 bytes at p, of which the first `need` (>= 1) are wanted: the
// aligned word holding p, and the next one only where it holds a wanted
// byte.
__device__ __forceinline__ uint32_t load4(const uint8_t* p, int need) {
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3u);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p - sh);
  const uint32_t lo = __ldg(w);
  const uint32_t hi = need > 4 - sh ? __ldg(w + 1) : 0u;
  return __funnelshift_r(lo, hi, 8 * sh);
}

// The 8 bytes at p, the first `need` (>= 1) wanted, as two words.
__device__ __forceinline__ uint2 load8(const uint8_t* p, int need) {
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3u);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p - sh);
  const uint32_t w0 = __ldg(w);
  const uint32_t w1 = need > 4 - sh ? __ldg(w + 1) : 0u;
  const uint32_t w2 = need > 8 - sh ? __ldg(w + 2) : 0u;
  return make_uint2(__funnelshift_r(w0, w1, 8 * sh), __funnelshift_r(w1, w2, 8 * sh));
}

// The 16 bytes at p, the first `need` (>= 1) wanted, as four words.
__device__ __forceinline__ void load16(const uint8_t* p, int need, uint32_t out[4]) {
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15u);
  const uint4 a = ldg16(p - sh);
  const uint4 b = need > 16 - sh ? ldg16(p - sh + 16) : make_uint4(0, 0, 0, 0);
  align16(a, b, sh, out);
}

// Staging bytes of 16 positions to 16 output bytes: four codes per byte
// (tab: a byte's four output bytes) or two (tab: a byte's two, in the
// low half).
__device__ __forceinline__ void decode4(uint32_t x, const uint32_t* tab, uint32_t out[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = tab[(x >> (8 * i)) & 0xFFu];
}

__device__ __forceinline__ void decode2(uint2 x, const uint32_t* tab, uint32_t out[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = i < 2 ? x.x : x.y;
    const int s = 16 * (i & 1);
    out[i] = tab[(w >> s) & 0xFFu] | tab[(w >> (s + 8)) & 0xFFu] << 16;
  }
}

__global__ void __launch_bounds__(kThreads)
    upload_unpack_kernel(const uint8_t* __restrict__ seq_up, const uint8_t* __restrict__ qual_up,
                         const int32_t* __restrict__ lens, const uint8_t* __restrict__ qtable,
                         uint8_t* __restrict__ seq, uint8_t* __restrict__ qual,
                         int32_t* __restrict__ lens_out, int n, int w, int L, int sw, int qw,
                         int modes) {
  __shared__ uint32_t tseq[256];
  __shared__ uint32_t tq[256];
  __shared__ uint8_t qt[16];
  const int tid = threadIdx.x;
  const bool qidx = (modes & (kQual2 | kQual4)) != 0;
  if (tid < 16) qt[tid] = (tid > 0 && qidx) ? qtable[tid] : 0;
  __syncthreads();
  {
    const unsigned b = tid;
    tseq[b] = (modes & kSeq2) ? (1u << (b >> 6)) | (1u << ((b >> 4) & 3)) << 8 |
                                    (1u << ((b >> 2) & 3)) << 16 | (1u << (b & 3)) << 24
                              : (b >> 4) | (b & 15) << 8;
    tq[b] = (modes & kQual2)   ? qt[b >> 6] | qt[(b >> 4) & 3] << 8 | qt[(b >> 2) & 3] << 16 |
                                   static_cast<uint32_t>(qt[b & 3]) << 24
            : (modes & kQual4) ? qt[b >> 4] | qt[b & 15] << 8
                               : 0u;
  }
  __syncthreads();
  const int C = L / kChunk;
  const int total = n * C;  // < 2^31 (the wrapper checks)
  int t = blockIdx.x * (kThreads * kUnpackTasks) + tid;
  if (t >= total) return;
  // row and chunk of the first task, then stepped by kThreads tasks
  int r = t / C;
  int c = t - r * C;
  const int dr = kThreads / C;
  const int dc = kThreads - dr * C;
#pragma unroll
  for (int i = 0; i < kUnpackTasks && t < total; ++i) {
    const int len = lens[r];
    if (c == 0) lens_out[r] = len;
    const int lim = len < w ? len : w;
    const int j0 = c * kChunk;
    uint32_t s[4] = {0, 0, 0, 0}, q[4] = {0, 0, 0, 0};
    const int npos = lim - j0;  // positions of the task kept, if > 0
    if (npos > 0) {
      const uint8_t* srow = seq_up + static_cast<size_t>(r) * sw;
      const uint8_t* qrow = qual_up + static_cast<size_t>(r) * qw;
      if (modes & kSeq2)
        decode4(load4(srow + j0 / 4, (min(npos, 16) + 3) >> 2), tseq, s);
      else
        decode2(load8(srow + j0 / 2, (min(npos, 16) + 1) >> 1), tseq, s);
      if (modes & kQual2)
        decode4(load4(qrow + j0 / 4, (min(npos, 16) + 3) >> 2), tq, q);
      else if (modes & kQual4)
        decode2(load8(qrow + j0 / 2, (min(npos, 16) + 1) >> 1), tq, q);
      else
        load16(qrow + j0, min(npos, 16), q);
      if (npos < kChunk) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t m = below(clampi(npos - 4 * k, 0, 4));
          s[k] &= m;
          q[k] &= m;
        }
      }
    }
    const size_t o = static_cast<size_t>(r) * L + j0;
    *reinterpret_cast<uint4*>(seq + o) = make_uint4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<uint4*>(qual + o) = make_uint4(q[0], q[1], q[2], q[3]);
    t += kThreads;
    r += dr;
    c += dc;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
}

struct Tiers {
  int hi, mod, lo, s_hi, s_mod, s_lo, s_bad;
};

// The tiers as byte-SIMD constants: x >= T for a byte x is
// ge_mask(x, T clamped to [0, 255]) & (T <= 255 ? ~0 : 0); scores are
// their low bytes (the int8 cast's wrap).
struct TierWords {
  uint32_t th[3], ok[3], sc[3], bad;  // hi, mod, lo
};

TierWords tier_words(const Tiers& t) {
  TierWords w;
  const int th[3] = {t.hi, t.mod, t.lo};
  const int sc[3] = {t.s_hi, t.s_mod, t.s_lo};
  for (int i = 0; i < 3; ++i) {
    const int c = th[i] < 0 ? 0 : (th[i] > 255 ? 255 : th[i]);
    w.th[i] = static_cast<uint32_t>(c) * 0x01010101u;
    w.ok[i] = th[i] > 255 ? 0u : kAll;
    w.sc[i] = static_cast<uint32_t>(sc[i] & 0xFF) * 0x01010101u;
  }
  w.bad = static_cast<uint32_t>(t.s_bad & 0xFF) * 0x01010101u;
  return w;
}

// 0xFF in each byte whose bit 7 is set (prmt's sign replication).
__device__ __forceinline__ uint32_t msb_mask(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(r) : "r"(x));
  return r;
}

// Per byte: the low 7 bits of a less those of b, biased by 128, so that
// no byte borrows from the next; bit 7 says whether a's were >= b's.
__device__ __forceinline__ uint32_t biased_diff(uint32_t a, uint32_t b) {
  return (a | 0x80808080u) - (b & 0x7F7F7F7Fu);
}

// Per byte, unsigned: a >= b as a byte mask.
__device__ __forceinline__ uint32_t ge_mask(uint32_t a, uint32_t b) {
  return msb_mask((a & ~b) | (~(a ^ b) & biased_diff(a, b)));
}

// Per byte, wrapping: a - b.
__device__ __forceinline__ uint32_t sub_bytes(uint32_t a, uint32_t b) {
  return biased_diff(a, b) ^ (~(a ^ b) & 0x80808080u);
}

__device__ __forceinline__ uint32_t eq_mask(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return ~msb_mask(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x);
}

// Per byte, wrapping: t + 4 and t - 3.
__device__ __forceinline__ uint32_t add4_bytes(uint32_t t) {
  return ((t & 0x7F7F7F7Fu) + 0x04040404u) ^ (t & 0x80808080u);
}

__device__ __forceinline__ uint32_t sub3_bytes(uint32_t t) {
  return ((t | 0x80808080u) - 0x03030303u) ^ (~t & 0x80808080u);
}

// pair.cpp:77-86, the last tier each byte of x reaches, as score bytes.
__device__ __forceinline__ uint32_t tier(uint32_t x, const TierWords& t) {
  uint32_t r = t.bad;
  r = sel(ge_mask(x, t.th[2]) & t.ok[2], t.sc[2], r);
  r = sel(ge_mask(x, t.th[1]) & t.ok[1], t.sc[1], r);
  return sel(ge_mask(x, t.th[0]) & t.ok[0], t.sc[0], r);
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

// One output row of a warp's batch.
struct Job {
  int row;    // the row written
  int mrow;   // the row whose original bytes are its mate's
  int d;      // the mate's column shift, in [0, L)
  int lo, hi; // the overlap [lo, hi), clipped to [0, L]
  int flags;  // bit 0 scored, bit 1 is_left
};

template <bool kPacked>
__device__ __forceinline__ Job make_job(const Geometry& g, int r, int mrow, int L) {
  int ms, ts, cl, left, scored;
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
  Job J;
  J.row = r;
  J.mrow = mrow;
  // int32 arithmetic that wraps, as the twin's int32 tensors do
  int d = static_cast<int>(static_cast<uint32_t>(ts) - static_cast<uint32_t>(ms)) % L;
  J.d = d < 0 ? d + L : d;
  const int end = static_cast<int>(static_cast<uint32_t>(ms) + static_cast<uint32_t>(cl));
  const int ml = g.my_len[r];
  J.lo = clampi(ms, 0, L);
  J.hi = clampi(end < ml ? end : ml, 0, L);
  J.flags = scored | left << 1;
  return J;
}

// Chunk c (positions 16c..16c+15) of job J's score and qual.
__device__ __forceinline__ void score_chunk(const uint8_t* __restrict__ seq,
                                            const uint8_t* __restrict__ qual, const Job& J, int c,
                                            int L, int C, const TierWords& tw, uint32_t smod,
                                            uint8_t* __restrict__ score,
                                            uint8_t* __restrict__ qual_out) {
  const int j0 = c * kChunk;
  const size_t o = static_cast<size_t>(J.row) * L + j0;
  const uint4 q4 = ldg16(qual + o);
  const uint32_t q[4] = {q4.x, q4.y, q4.z, q4.w};
  uint32_t so[4], qo[4];
  const bool scored = J.flags & 1;
  if (!scored || max(J.lo, j0) >= min(J.hi, j0 + kChunk)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      so[i] = scored ? tier(q[i], tw) : smod;
      qo[i] = q[i];
    }
  } else {
    const uint4 s4 = ldg16(seq + o);
    const uint32_t s[4] = {s4.x, s4.y, s4.z, s4.w};
    int s0 = j0 + J.d;
    if (s0 >= L) s0 -= L;
    const int k0 = s0 >> 4;
    const int k1 = k0 + 1 == C ? 0 : k0 + 1;
    const int sh = s0 & 15;
    const size_t mo = static_cast<size_t>(J.mrow) * L;
    const uint4 z = make_uint4(0, 0, 0, 0);
    const uint4 ps0 = ldg16(seq + mo + 16 * k0);
    const uint4 pq0 = ldg16(qual + mo + 16 * k0);
    const uint4 ps1 = sh ? ldg16(seq + mo + 16 * k1) : z;
    const uint4 pq1 = sh ? ldg16(qual + mo + 16 * k1) : z;
    uint32_t ps[4], pq[4];
    align16(ps0, ps1, sh, ps);
    align16(pq0, pq1, sh, pq);
    const uint32_t lw = (J.flags & 2) ? kAll : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = j0 + 4 * i;
      const uint32_t in = below(clampi(J.hi - p, 0, 4)) & ~below(clampi(J.lo - p, 0, 4));
      const uint32_t eq = eq_mask(s[i], ps[i]);
      const uint32_t h = (q[i] & pq[i]) + (((q[i] ^ pq[i]) >> 1) & 0x7F7F7F7Fu);
      const uint32_t ge = ge_mask(q[i], pq[i]);  // q >= pq
      const uint32_t le = ge_mask(pq[i], q[i]);  // q <= pq
      const uint32_t dpos = sub_bytes(q[i], pq[i]) & ge;
      const uint32_t win = ~le | (ge & lw);
      // the tier's argument: q outside the overlap, the mean on a match,
      // the difference (q >= pq where it counts) on a mismatch
      const uint32_t t = tier(sel(in, sel(eq, h, dpos), q[i]), tw);
      const uint32_t adj = sel(eq, add4_bytes(t), sub3_bytes(t) & win);
      so[i] = sel(in, adj, t);
      qo[i] = sel(in & ~eq, dpos, q[i]);
    }
  }
  *reinterpret_cast<uint4*>(score + o) = make_uint4(so[0], so[1], so[2], so[3]);
  *reinterpret_cast<uint4*>(qual_out + o) = make_uint4(qo[0], qo[1], qo[2], qo[3]);
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
    score_map_kernel(const uint8_t* __restrict__ seq, const uint8_t* __restrict__ qual,
                     const Geometry g, uint8_t* __restrict__ score,
                     uint8_t* __restrict__ qual_out, int N, int L, const TierWords tw,
                     uint32_t smod, int batch) {
  __shared__ Job jobs[kWarps][2 * kBatch];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // lane l < batch: row base + l, its clamped mate, and whether the two
  // name each other (a pair, taken by the warp of its lower row)
  const int r = (blockIdx.x * kWarps + warp) * batch + lane;
  const bool own = lane < batch && r < N;
  int m = r;
  bool pair = false;
  if (own) {
    m = clampi(g.mate[r], 0, N - 1);
    if (m != r) pair = clampi(g.mate[m], 0, N - 1) == r;
  }
  const bool take_own = own && !(pair && m < r);
  const bool take_mate = pair && m > r;
  const unsigned b_own = __ballot_sync(kAll, take_own);
  const unsigned b_mate = __ballot_sync(kAll, take_mate);
  const unsigned lower = (1u << lane) - 1u;
  const int pos = __popc(b_own & lower) + __popc(b_mate & lower);
  Job* const wj = jobs[warp];
  if (take_own) wj[pos] = make_job<kPacked>(g, r, m, L);
  if (take_mate) wj[pos + 1] = make_job<kPacked>(g, m, r, L);
  __syncwarp();
  const int C = L / kChunk;
  const int tasks = (__popc(b_own) + __popc(b_mate)) * C;
  // the lane's tasks: lane, lane + 32, ... of the (job, chunk) pairs
  int k = lane / C;
  int c = lane - k * C;
  const int dk = 32 / C;
  const int dc = 32 - dk * C;
  for (int t = lane; t < tasks; t += 32) {
    score_chunk(seq, qual, wj[k], c, L, C, tw, smod, score, qual_out);
    k += dk;
    c += dc;
    if (c >= C) {
      c -= C;
      ++k;
    }
  }
}

// Blocks of the score map resident at once on the card, per device and
// form (0: not asked yet).
constexpr int kMaxDevices = 64;
std::atomic<int> resident[kMaxDevices][2];

int resident_blocks(bool packed, cudaError_t* err) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  std::atomic<int>* cached = e == cudaSuccess && dev < kMaxDevices ? &resident[dev][packed] : nullptr;
  int n = cached != nullptr ? cached->load(std::memory_order_relaxed) : 0;
  if (e == cudaSuccess && n == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, packed ? score_map_kernel<true> : score_map_kernel<false>, kThreads, 0);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    n = per_sm * sms;
    if (e == cudaSuccess && cached != nullptr) cached->store(n, std::memory_order_relaxed);
  }
  *err = e;
  return e == cudaSuccess ? n : 0;
}

// Rows per warp: kBatch, or fewer where the N rows' warps would not fill
// the card's resident warps (a warp walks its batch's tasks one pass of
// lanes after another, each pass a round trip to memory, so a grid of
// one short wave waits on few, long warps).
int batch_for(int N, bool packed, cudaError_t* err) {
  const long long warps = static_cast<long long>(resident_blocks(packed, err)) * kWarps;
  if (*err != cudaSuccess) return 0;
  const long long b = (N + warps - 1) / warps;
  return static_cast<int>(b < kMinBatch ? kMinBatch : (b > kBatch ? kBatch : b));
}

bool misaligned(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) != 0;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = success). seq_up u8
// [n, sw], qual_up u8 [n, qw], lens i32 [n], qtable u8 [16] (read only
// with 2- or 4-bit quals); outputs seq, qual u8 [n, L] (16-byte aligned,
// L % 16 == 0) and lens_out i32 [n]; n * L / 16 < 2^31. modes: 1 2-bit
// seq (else 4-bit), 2 2-bit qual, 4 4-bit qual (neither: raw, qw >= w).
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
  const long long total = static_cast<long long>(n) * (L / kChunk);
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(kThreads) * kUnpackTasks;
  const int grid = static_cast<int>((total + per_block - 1) / per_block);
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
  const int batch = batch_for(N, packed != 0, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows_per_block = static_cast<long long>(kWarps) * batch;
  const long long grid = (N + rows_per_block - 1) / rows_per_block;
  Geometry g;
  g.mate = static_cast<const int32_t*>(mate);
  g.meta = static_cast<const int32_t*>(meta);
  g.my_start = static_cast<const int32_t*>(my_start);
  g.mate_start = static_cast<const int32_t*>(mate_start);
  g.cmp_len = static_cast<const int32_t*>(cmp_len);
  g.is_left = static_cast<const uint8_t*>(is_left);
  g.scored = static_cast<const uint8_t*>(scored);
  g.my_len = static_cast<const int32_t*>(my_len);
  const TierWords tw = tier_words(Tiers{hi, mod, lo, s_hi, s_mod, s_lo, s_bad});
  const uint32_t smod = static_cast<uint32_t>(s_mod & 0xFF) * 0x01010101u;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* s8 = static_cast<const uint8_t*>(seq);
  const uint8_t* q8 = static_cast<const uint8_t*>(qual);
  uint8_t* so = static_cast<uint8_t*>(score);
  uint8_t* qo = static_cast<uint8_t*>(qual_out);
  if (packed)
    score_map_kernel<true><<<static_cast<int>(grid), kThreads, 0, st>>>(s8, q8, g, so, qo, N, L,
                                                                         tw, smod, batch);
  else
    score_map_kernel<false><<<static_cast<int>(grid), kThreads, 0, st>>>(s8, q8, g, so, qo, N, L,
                                                                          tw, smod, batch);
  return static_cast<int>(cudaGetLastError());
}
