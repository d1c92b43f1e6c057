// The window's upload rebuild and overlap scoring, fused: from the sparse
// staging that crossed in one copy, the resident seq and qual matrices
// [n, L] of every read row, then Pair::computeScore (pair.cpp:88-172)
// over every row: the scores [n, L] and the rewritten quals.
//
// Replaces, on the JAX side, the one jitted program
// gencore_tpu/engine.py:3034 _upload_score_fn: the rebuild
// _upload_sparse_trace (:2938; K4), then either
// gencore_tpu/core/kernels.py:373 score_map_kernel_packed (-> :310
// score_map_kernel; K5) or, when no mates overlap, the qual tier of the
// rows a bit mask marks as scored (engine.py:3054-3065; K6); and, for
// windows of more than 65,536 rows, the JAX engine's non-deferred pair of
// programs _upload_sparse_fn (:3018) and score_map_kernel with int32
// mate rows. Its twin is engine._upload_score_plain.
//
// What it computes, row r of n (all integer, every byte exact):
//   * seq: dense row src[r] (clamped to the rows): 2-bit rows decode code
//     c to 1 << c, high bits first, row 0 the reserved zero row; 4-bit
//     rows take the high nibble first; rows nd.. are genome slots, slot t
//     the genome at clamp(gsl[t], 0, max(G - w, 0)); then the row's seq
//     edits (offset: the exclusive prefix sum of every row's count; edit
//     c applies while c < count and c < 12, at a position < w, the later
//     edit winning), then zero at and beyond the row's length;
//   * qual: the row's base value, or dense qual row q_src[r] - 1
//     (clamped) where q_src[r] > 0, then the qual edits, then the mask;
//   * columns w..L-1 zero; lengths lens16[r], or with const_lens
//     lens16[0] for rows below lens16[1] and 0 for the rest;
//   * score: meta[r] = my_start 8b | mate_start 8b | cmp_len 9b | is_left
//     bit 25 | scored bit 26; the mate mate[r] (u16, or u32 with mate32;
//     clamped) rebuilt as above; position j of the overlap (my_start <= j
//     < my_start + cmp_len, j < length) meets the mate's column (j +
//     mate_start - my_start) mod L: a match scores q2s((q + pq) / 2) + 4,
//     a mismatch q2s(q - pq) - 3 for the row that wins (q > pq, the left
//     mate winning ties) and 0 for the other, and the scored row's qual
//     becomes max(q - pq, 0); elsewhere q2s(q); unscored rows score s_mod;
//   * with no_overlap, meta is the little-order bit mask of scored rows:
//     a scored row scores q2s(q), the others s_mod; quals stay.
//
// Bound: bytes. The outputs are 3 bytes per (row, position) against a
// staging of a few bytes per row, so the bound is the outputs' write and
// the staging's read at 3.35 TB/s; the integer work per position is a few
// dozen operations. What holds it back is latency and the instruction
// rate: each row's bytes come at the end of a chain of dependent loads
// (its scalars -> the dense row or genome slot; the chunk offsets -> the
// edit streams), a warp walks its rows one after another, and the first
// version of this kernel rebuilt every scored row twice (as itself and as
// its mate's mate) and stored bytes, 15 store instructions per row (a
// clock64() split: the two rebuilds 71-73% of its time, the prologue
// 7-10%).
//
// Design (Hopper): one cooperative launch, persistent blocks of 8 warps.
// Phase 1: each block scans the seq and qual edit counts of a chunk of
// rows (local exclusive offsets) and publishes the chunk's totals; one
// grid barrier; each block then scans the chunks' totals into shared
// memory, so the offset of any row is its local offset plus its chunk's.
// Phase 2: a warp takes batches of 8 rows (the first by stride, the rest
// from a ticket): lanes 0-7 load the batch's scalars in one round and
// lanes 8-15 those of the rows' mates, into shared memory. A scored row
// whose mate is scored and names it back is a mate pair: the warp of the
// lower row rebuilds both rows once, scores both from the original quals
// and writes all six rows; the higher row is skipped. Any other scored
// row rebuilds its mate beside itself. A rebuild loads both rows' words
// (one byte of a 2-bit row, two of a 4-bit row or a genome word per four
// positions and lane) together with their edits (a half-warp per row,
// lane c holding edit c; a lane's edit loses to a later one of the same
// position by __match_any_sync), the length mask applied as the words
// land in shared memory. The score reads q2s from a 256-entry table in
// shared memory, unrolled and without branches, and the three outputs
// leave shared memory as 16-byte stores (L / 16 per row and output).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "staging.cuh"

namespace {

using gc_staging::clampi;

constexpr int kDims = 36;      // the ints of the host's dims array
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 256;
constexpr int kMaxGrid = 1280;  // resident blocks: 8 per SM x 132 SMs, and slack
constexpr int kCap = 12;        // edits per row (engine._SPARSE_SEQ_CAP, _QUAL_CAP)
constexpr int kBatch = 8;       // rows per warp batch: lanes 0-7, their mates 8-15
constexpr unsigned kAll = 0xffffffffu;

enum Flags {
  kMode2 = 1,
  kSedit = 2,
  kQdense = 4,
  kQedit = 8,
  kConstLens = 16,
  kGenome = 32,
  kNoOverlap = 64,
  kMate32 = 128
};

struct Params {
  const uint8_t* sd;
  const uint16_t* src;
  const uint8_t* scnt;
  const uint8_t* epos;
  const uint8_t* ecode;
  const uint8_t* base;
  const uint16_t* q_src;
  const uint8_t* qd;
  const uint8_t* qcnt;
  const uint8_t* qpos;
  const uint8_t* qval;
  const void* lens16;
  const void* mate;  // u16 [n], or u32 [n] with kMate32
  const void* meta;
  const int32_t* gsl;
  unsigned* bar;
  const uint8_t* genome;
  uint8_t* seq_out;
  uint8_t* qual_out;
  int8_t* score_out;
  int32_t* offs;  // [2, n]: each row's exclusive offset within its chunk
  int2* bsum;     // [grid]: each chunk's totals
  int n, w, L, flags, nd, bw, ns, G, E, Eq, nq, qw;
  int hi, mod, lo, s_hi, s_mod, s_lo, s_bad;
  int chunk;  // rows per chunk of the offset scan
};

__device__ __forceinline__ int2 add2(int2 a, int2 b) { return make_int2(a.x + b.x, a.y + b.y); }

// Exclusive scan of v over the block (kThreads threads); *total gets the
// block's sum. Every thread of the block must call it.
__device__ __forceinline__ int2 block_exscan(int2 v, int2* total) {
  __shared__ int2 ws[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int2 y = make_int2(__shfl_up_sync(kAll, x.x, o), __shfl_up_sync(kAll, x.y, o));
    if (lane >= o) x = add2(x, y);
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int2 s = lane < kWarps ? ws[lane] : make_int2(0, 0);
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int2 y = make_int2(__shfl_up_sync(kAll, s.x, o), __shfl_up_sync(kAll, s.y, o));
      if (lane >= o) s = add2(s, y);
    }
    if (lane < kWarps) ws[lane] = s;
  }
  __syncthreads();
  const int2 pre = warp > 0 ? ws[warp - 1] : make_int2(0, 0);
  *total = ws[kWarps - 1];
  __syncthreads();  // ws is read before the next call writes it
  return make_int2(pre.x + x.x - v.x, pre.y + x.y - v.y);
}

// Every block of the (cooperative, so co-resident) grid arrives before any
// leaves; the counter comes zeroed with the upload and is used once.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
    } while (v < gridDim.x);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ int q2s(int q, const Params& p) {
  return q >= p.hi ? p.s_hi : (q >= p.mod ? p.s_mod : (q >= p.lo ? p.s_lo : p.s_bad));
}

__device__ __forceinline__ int row_len(const Params& p, int r) {
  if (p.flags & kConstLens) {
    const int32_t* l = static_cast<const int32_t*>(p.lens16);
    return r < l[1] ? l[0] : 0;
  }
  return static_cast<const uint16_t*>(p.lens16)[r];
}

__device__ __forceinline__ int mate_of(const Params& p, int r) {
  if (p.flags & kMate32) {
    const uint32_t m = static_cast<const uint32_t*>(p.mate)[r];
    return static_cast<int>(m < static_cast<uint32_t>(p.n) ? m : static_cast<uint32_t>(p.n - 1));
  }
  return clampi(static_cast<const uint16_t*>(p.mate)[r], 0, p.n - 1);
}

// What a row's rebuild reads, loaded up front.
struct Row {
  const uint8_t* d;  // its dense row, or null
  const uint8_t* g;  // its genome slice, or null
  const uint8_t* q;  // its dense qual row, or null
  int qb;            // its qual base value
  int len;           // its length (lens16)
  int lim;           // positions kept: clamp(len, 0, w)
  int sc, so;        // seq edits applied and their flat offset
  int qc, qo;        // qual edits applied and their flat offset
  bool zero;         // the reserved 2-bit row 0
};

// Row r's scalars; bpre: each chunk's exclusive offsets.
__device__ __forceinline__ Row load_row(const Params& p, const int2* bpre, int r) {
  Row R;
  const int nrows = p.nd + ((p.flags & kGenome) ? p.ns : 0);
  const int s = clampi(p.src[r], 0, nrows - 1);
  const int chunk = r / p.chunk;
  R.qb = p.base[r];
  R.len = row_len(p, r);
  R.sc = R.so = R.qc = R.qo = 0;
  if (p.flags & kSedit) {
    R.sc = min(static_cast<int>(p.scnt[r]), kCap);
    R.so = __ldcg(p.offs + r) + bpre[chunk].x;
  }
  if (p.flags & kQedit) {
    R.qc = min(static_cast<int>(p.qcnt[r]), kCap);
    R.qo = __ldcg(p.offs + p.n + r) + bpre[chunk].y;
  }
  R.q = nullptr;
  if (p.flags & kQdense) {
    const int qs = p.q_src[r];
    if (qs > 0) R.q = p.qd + static_cast<size_t>(clampi(qs - 1, 0, p.nq - 1)) * p.qw;
  }
  R.d = nullptr;
  R.g = nullptr;
  if (s < p.nd) {
    R.d = p.sd + static_cast<size_t>(s) * p.bw;
  } else {
    const int hi_start = p.G - p.w > 0 ? p.G - p.w : 0;
    R.g = p.genome + clampi(p.gsl[s - p.nd], 0, hi_start);
  }
  R.zero = (p.flags & kMode2) && s == 0;
  R.lim = clampi(R.len, 0, p.w);
  return R;
}

// Positions 4k..4k+3 of a row's seq, as one little-order word; bytes at or
// past `valid` are left to the caller's mask.
__device__ __forceinline__ uint32_t seq_word(const Params& p, const Row& R, int k, int valid) {
  if (R.g != nullptr) {
    const uint8_t* a = R.g + 4 * k;
    const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(a) & 3u);
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(a - mis);
    if (a - mis >= p.genome && reinterpret_cast<const uint8_t*>(wp + 2) <= p.genome + p.G) {
      const uint32_t lo = __ldg(wp);
      const uint32_t hi = mis ? __ldg(wp + 1) : 0u;
      return __funnelshift_r(lo, hi, 8 * mis);
    }
    uint32_t v = 0;
    for (int t = 0; t < 4 && t < valid; ++t) v |= static_cast<uint32_t>(a[t]) << (8 * t);
    return v;
  }
  if (p.flags & kMode2) {
    if (R.zero) return 0u;
    const unsigned b = R.d[k];
    return (1u << ((b >> 6) & 3)) | (1u << (((b >> 4) & 3) + 8)) | (1u << (((b >> 2) & 3) + 16)) |
           (1u << ((b & 3) + 24));
  }
  const unsigned b0 = R.d[2 * k];
  const unsigned b1 = 2 * k + 1 < p.bw ? R.d[2 * k + 1] : 0u;
  return (b0 >> 4) | ((b0 & 15) << 8) | ((b1 >> 4) << 16) | ((b1 & 15) << 24);
}

__device__ __forceinline__ uint32_t qual_word(const Row& R, int k, int valid) {
  if (R.q == nullptr) return static_cast<uint32_t>(R.qb) * 0x01010101u;
  uint32_t v = 0;
  for (int t = 0; t < 4 && t < valid; ++t) v |= static_cast<uint32_t>(R.q[4 * k + t]) << (8 * t);
  return v;
}

// Positions 4k..4k+3 of row R into its shared rows sq / ql: decoded, zero
// at and past its lim.
__device__ __forceinline__ void put_word(const Params& p, const Row& R, int k, uint8_t* sq,
                                         uint8_t* ql) {
  const int valid = R.lim - 4 * k;
  uint32_t s = 0, q = 0;
  if (valid > 0) {
    s = seq_word(p, R, k, valid);
    q = qual_word(R, k, valid);
    if (valid < 4) {
      const uint32_t m = (1u << (8 * valid)) - 1u;
      s &= m;
      q &= m;
    }
  }
  reinterpret_cast<uint32_t*>(sq)[k] = s;
  reinterpret_cast<uint32_t*>(ql)[k] = q;
}

// Rows A and, with two, B rebuilt into shared memory by the calling warp:
// seq into sq[0] / sq[1], qual into ql[0] / ql[1], each [L], zero at and
// past each row's lim. Lanes 0-15 hold row A's edits, lanes 16-31 row
// B's; their loads go out with the rows' bytes.
__device__ __forceinline__ void rebuild(const Params& p, const Row& A, const Row& B, bool two,
                                        uint8_t* const* sq, uint8_t* const* ql, int lane) {
  const int mine_b = lane >> 4;
  const int hl = lane & 15;
  // this lane's seq and qual edit (positions are u8, so < 256)
  const int sc = mine_b ? (two ? B.sc : 0) : A.sc;
  const int qc = mine_b ? (two ? B.qc : 0) : A.qc;
  int sp = -1, sv = 0, qp = -1, qv = 0;
  if (hl < sc) {
    const int idx = clampi((mine_b ? B.so : A.so) + hl, 0, p.E - 1);
    sp = p.epos[idx];
    sv = p.ecode[idx];
  }
  if (hl < qc) {
    const int idx = clampi((mine_b ? B.qo : A.qo) + hl, 0, p.Eq - 1);
    qp = p.qpos[idx];
    qv = p.qval[idx];
  }
  // both rows' words in one unrolled loop, so that their loads are in
  // flight together
#pragma unroll
  for (int i = 0; i < kMaxL / 128; ++i) {
    const int k = lane + 32 * i;
    if (k < (p.L >> 2)) {
      put_word(p, A, k, sq[0], ql[0]);
      if (two) put_word(p, B, k, sq[1], ql[1]);
    }
  }
  // the later edit of a position wins: a lane writes unless a higher lane
  // of its half holds an edit of the same position
  const unsigned s_same = __match_any_sync(kAll, sp >= 0 ? (mine_b << 8) | sp : 0x10000 | lane);
  const unsigned q_same = __match_any_sync(kAll, qp >= 0 ? (mine_b << 8) | qp : 0x10000 | lane);
  __syncwarp();
  const int lim = mine_b ? B.lim : A.lim;
  if (sp >= 0 && sp < lim && (s_same >> lane) == 1u) sq[mine_b][sp] = static_cast<uint8_t>(sv);
  if (qp >= 0 && qp < lim && (q_same >> lane) == 1u) ql[mine_b][qp] = static_cast<uint8_t>(qv);
  __syncwarp();
}

// Row outputs into shared memory: qual qo and score so [L] (its seq is
// s as rebuilt), against the mate's rows ms / mq; tab: q2s of every u8.
__device__ __forceinline__ void score_row(const Params& p, const int8_t* tab, bool no_ov,
                                          bool scored, unsigned m, int len, const uint8_t* s,
                                          const uint8_t* q, const uint8_t* ms, const uint8_t* mq,
                                          uint8_t* qo, uint8_t* so, int lane) {
  const int L = p.L;
  // unrolled and without branches, so that the positions' loads overlap
  if (no_ov || !scored) {
#pragma unroll
    for (int i = 0; i < kMaxL / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < L) {
        const int qq = q[j];
        qo[j] = static_cast<uint8_t>(qq);
        so[j] = static_cast<uint8_t>(scored ? tab[qq] : p.s_mod);
      }
    }
    return;
  }
  const int st = m & 0xFF;
  const int ts = (m >> 8) & 0xFF;
  const int end = min(st + static_cast<int>((m >> 16) & 0x1FF), len);
  const bool left = (m >> 25) & 1u;
  const int delta = ((ts - st) % L + L) % L;
#pragma unroll
  for (int i = 0; i < kMaxL / 32; ++i) {
    const int j = lane + 32 * i;
    if (j < L) {
      int k = j + delta;
      if (k >= L) k -= L;
      const int qq = q[j];
      const int pq = mq[k];
      const bool in = j >= st && j < end;
      const bool match = s[j] == ms[k];
      const bool win = qq > pq || (left && qq == pq);
      const int d = qq - pq;
      // the tier's argument: q outside the overlap, the mean on a match,
      // the difference for the winner of a mismatch
      const int v = tab[!in ? qq : match ? (qq + pq) >> 1 : win ? d : 0];
      so[j] = static_cast<uint8_t>(!in ? v : match ? v + 4 : win ? v - 3 : 0);
      qo[j] = static_cast<uint8_t>(in && !match && d < 0 ? 0 : in && !match ? d : qq);
    }
  }
}

// Row `row`'s three outputs from shared memory, 16 bytes a lane: slot
// (o << 12 | byte offset) names output o (seq, qual, score) and the
// vector; -1 none.
__device__ __forceinline__ void store_row(const Params& p, int row, const uint8_t* s,
                                          const uint8_t* q, const uint8_t* sc, int slot) {
  if (slot < 0) return;
  const int o = slot >> 12;
  const int c = slot & 0xFFF;
  const uint8_t* from = (o == 0 ? s : o == 1 ? q : sc) + c;
  uint8_t* to = (o == 0 ? p.seq_out : o == 1 ? p.qual_out : reinterpret_cast<uint8_t*>(p.score_out)) +
                static_cast<size_t>(row) * p.L + c;
  *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
}

__global__ void __launch_bounds__(kThreads) upload_score_kernel(const Params p) {
  __shared__ int2 bpre[kMaxGrid];
  __shared__ int8_t tab[256];
  // per warp: its batch's rows and their mates' (lanes kBatch..)
  __shared__ Row batch[kWarps][2 * kBatch];
  // per warp: seq and qual of rows A and B as rebuilt, then the qual and
  // score outputs of A and B
  __shared__ __align__(16) uint8_t rows[kWarps][8][kMaxL];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n = p.n;
  const int L = p.L;
  for (int q = t; q < 256; q += kThreads) tab[q] = static_cast<int8_t>(q2s(q, p));
  __syncthreads();

  if (p.flags & (kSedit | kQedit)) {
    // phase 1: each row's offset within its chunk, the chunk's totals
    const int lo = static_cast<int>(blockIdx.x) * p.chunk;
    const int hi = min(n, lo + p.chunk);
    int2 carry = make_int2(0, 0);
    for (int b = lo; b < hi; b += kThreads) {
      const int r = b + t;
      int2 v = make_int2(0, 0);
      if (r < hi) {
        if (p.flags & kSedit) v.x = p.scnt[r];
        if (p.flags & kQedit) v.y = p.qcnt[r];
      }
      int2 tot;
      const int2 ex = block_exscan(v, &tot);
      if (r < hi) {
        p.offs[r] = carry.x + ex.x;
        p.offs[n + r] = carry.y + ex.y;
      }
      carry = add2(carry, tot);
    }
    if (t == 0) p.bsum[blockIdx.x] = carry;
    grid_barrier(p.bar);
    // every chunk's exclusive offset
    carry = make_int2(0, 0);
    for (int b = 0; b < static_cast<int>(gridDim.x); b += kThreads) {
      const int i = b + t;
      int2 v = make_int2(0, 0);
      if (i < static_cast<int>(gridDim.x)) {
        const int2* at = p.bsum + i;
        v = make_int2(__ldcg(&at->x), __ldcg(&at->y));
      }
      int2 tot;
      const int2 ex = block_exscan(v, &tot);
      if (i < static_cast<int>(gridDim.x)) bpre[i] = add2(carry, ex);
      carry = add2(carry, tot);
    }
    __syncthreads();
  }

  // phase 2: a warp takes batches of kBatch rows; a mate pair goes to the
  // warp of its lower row
  uint8_t* const sq[2] = {rows[warp][0], rows[warp][2]};
  uint8_t* const ql[2] = {rows[warp][1], rows[warp][3]};
  uint8_t* const qo[2] = {rows[warp][4], rows[warp][6]};
  uint8_t* const so[2] = {rows[warp][5], rows[warp][7]};
  Row* const bw = batch[warp];
  const bool no_ov = (p.flags & kNoOverlap) != 0;
  // this lane's two 16-byte store slots of a row's three outputs
  int slot[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = lane + 32 * i;
    const int V = L >> 4;
    slot[i] = v < 3 * V ? (v / V) << 12 | (v % V) << 4 : -1;
  }
  const int nbatch = (n + kBatch - 1) / kBatch;
  const int stride = static_cast<int>(gridDim.x) * kWarps;
  unsigned* const ticket = p.bar + 1;
  for (int b = static_cast<int>(blockIdx.x) * kWarps + warp; b < nbatch;) {
    // lanes l and l + kBatch both read row b * kBatch + l's meta and
    // mate; lane l + kBatch then loads that mate's scalars and whether it
    // names the row back
    const int own = b * kBatch + (lane & (kBatch - 1));
    const bool in = lane < 2 * kBatch && own < n;
    const bool mine_mate = lane >= kBatch;
    bool scored = false;
    unsigned meta = 0;
    int mate = own;
    if (in) {
      if (no_ov) {
        scored = (static_cast<const uint8_t*>(p.meta)[own >> 3] >> (own & 7)) & 1;
      } else {
        meta = static_cast<const uint32_t*>(p.meta)[own];
        scored = (meta >> 26) & 1u;
        if (scored) mate = mate_of(p, own);
      }
    }
    const bool two = mate != own;
    unsigned mb = 0;
    bool pair = false;
    if (in && (!mine_mate || two)) {
      const int row = mine_mate ? mate : own;
      bw[lane] = load_row(p, bpre, row);
      if (mine_mate) {
        mb = static_cast<const uint32_t*>(p.meta)[mate];
        pair = ((mb >> 26) & 1u) && mate_of(p, mate) == own;
      }
    }
    pair = __shfl_sync(kAll, pair, (lane & (kBatch - 1)) | kBatch);
    mb = __shfl_sync(kAll, mb, (lane & (kBatch - 1)) | kBatch);
    // the rows this warp writes: each row of the batch but the higher
    // row of a pair
    unsigned todo = __ballot_sync(kAll, !mine_mate && in && !(pair && mate < own));
    __syncwarp();
    while (todo) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const int r = b * kBatch + i;
      const int m = __shfl_sync(kAll, mate, i);
      const bool pr = __shfl_sync(kAll, pair, i);
      const bool sc = __shfl_sync(kAll, scored, i);
      const unsigned ma = __shfl_sync(kAll, meta, i);
      const unsigned mbi = __shfl_sync(kAll, mb, i);
      const bool tw = m != r;
      const Row A = bw[i];
      Row B = A;
      if (tw) B = bw[kBatch + i];
      rebuild(p, A, B, tw, sq, ql, lane);
      // a row without a mate row of its own scores against itself
      const int mi = tw ? 1 : 0;
      score_row(p, tab, no_ov, sc, ma, A.len, sq[0], ql[0], sq[mi], ql[mi], qo[0], so[0], lane);
      if (pr) score_row(p, tab, false, true, mbi, B.len, sq[1], ql[1], sq[0], ql[0], qo[1], so[1], lane);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 2; ++k) store_row(p, r, sq[0], qo[0], so[0], slot[k]);
      if (pr) {
#pragma unroll
        for (int k = 0; k < 2; ++k) store_row(p, m, sq[1], qo[1], so[1], slot[k]);
      }
      __syncwarp();  // the buffers are read before the next row writes them
    }
    // the first batch by stride, the rest from the ticket
    int next = 0;
    if (lane == 0) next = stride + static_cast<int>(atomicAdd(ticket, 1u));
    b = __shfl_sync(kAll, next, 0);
  }
}

// Blocks resident at once on the card, per device (0: not asked yet).
constexpr int kMaxDevices = 64;
std::atomic<int> resident[kMaxDevices];

int resident_blocks(cudaError_t* err) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  std::atomic<int>* cached = e == cudaSuccess && dev < kMaxDevices ? &resident[dev] : nullptr;
  int n = cached != nullptr ? cached->load(std::memory_order_relaxed) : 0;
  if (e == cudaSuccess && n == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, upload_score_kernel, kThreads, 0);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    n = per_sm * sms;
    if (e == cudaSuccess && cached != nullptr) cached->store(n, std::memory_order_relaxed);
  }
  *err = e;
  return e == cudaSuccess ? n : 0;
}

// The grid of a launch of n rows: the resident blocks, at most one per
// kWarps rows and kMaxGrid.
int grid_for(int n, cudaError_t* err) {
  int grid = resident_blocks(err);
  if (*err != cudaSuccess) return 0;
  const int want = (n + kWarps - 1) / kWarps;
  if (grid > want) grid = want;
  if (grid > kMaxGrid) grid = kMaxGrid;
  return grid;
}

}  // namespace

// The grid a launch of n > 0 rows takes on the current device, or a
// negated cudaError_t.
extern "C" int gc_upload_score_grid(int n) {
  cudaError_t e;
  const int grid = grid_for(n, &e);
  return e == cudaSuccess ? grid : -static_cast<int>(e);
}

// Launch on `stream`; returns a cudaError_t (0 = success). `up` is the
// device copy of the staging buffer (core/kernels.upload_score_layout);
// dims (host, kDims ints): kDims, n, w, L, flags (mode2 1, has_sedit 2,
// has_qdense 4, has_qedit 8, const_lens 16, has_genome 32, no_overlap
// 64, mate32 128), nd, bw (bytes per dense row), ns (genome slots), G, E,
// Eq, nq, qw (dense qual rows and their width), hi, mod, lo, s_hi, s_mod,
// s_lo, s_bad, then the byte offsets in `up` of sd, src, scnt, epos,
// ecode, base, q_src, qd, qcnt, qpos, qval, lens16, mate, meta, gsl and
// the barrier word (zeroed by the host). genome u8 [G] (has_genome) or
// null; outputs seq, qual u8 [n, L] and score i8 [n, L], 16-byte aligned
// with L % 16 == 0; scratch i32 [2 n + 2 kMaxGrid].
extern "C" int gc_upload_score(void* up, const void* genome, void* seq, void* qual, void* score,
                               void* scratch, const int* dims, void* stream) {
  if (dims == nullptr || dims[0] != kDims) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.n = dims[1];
  p.w = dims[2];
  p.L = dims[3];
  p.flags = dims[4];
  p.nd = dims[5];
  p.bw = dims[6];
  p.ns = dims[7];
  p.G = dims[8];
  p.E = dims[9];
  p.Eq = dims[10];
  p.nq = dims[11];
  p.qw = dims[12];
  p.hi = dims[13];
  p.mod = dims[14];
  p.lo = dims[15];
  p.s_hi = dims[16];
  p.s_mod = dims[17];
  p.s_lo = dims[18];
  p.s_bad = dims[19];
  if (p.n <= 0) return 0;
  const bool genome_rows = (p.flags & kGenome) != 0;
  if (p.w <= 0 || p.L < p.w || p.L > kMaxL || p.L % 16 != 0 || p.nd <= 0 || p.bw <= 0 ||
      (p.flags & kMode2 ? 4 : 2) * p.bw < p.w || (genome_rows && (p.ns <= 0 || p.G < p.w)) ||
      ((p.flags & kSedit) && p.E <= 0) || ((p.flags & kQedit) && p.Eq <= 0) ||
      ((p.flags & kQdense) && (p.nq <= 0 || p.qw != p.w)) || (genome_rows && genome == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(seq) | reinterpret_cast<uintptr_t>(qual) |
       reinterpret_cast<uintptr_t>(score)) & 15u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  uint8_t* const b = static_cast<uint8_t*>(up);
  const int* off = dims + 20;
  p.sd = b + off[0];
  p.src = reinterpret_cast<const uint16_t*>(b + off[1]);
  p.scnt = b + off[2];
  p.epos = b + off[3];
  p.ecode = b + off[4];
  p.base = b + off[5];
  p.q_src = reinterpret_cast<const uint16_t*>(b + off[6]);
  p.qd = b + off[7];
  p.qcnt = b + off[8];
  p.qpos = b + off[9];
  p.qval = b + off[10];
  p.lens16 = b + off[11];
  p.mate = b + off[12];
  p.meta = b + off[13];
  p.gsl = reinterpret_cast<const int32_t*>(b + off[14]);
  p.bar = reinterpret_cast<unsigned*>(b + off[15]);
  p.genome = static_cast<const uint8_t*>(genome);
  p.seq_out = static_cast<uint8_t*>(seq);
  p.qual_out = static_cast<uint8_t*>(qual);
  p.score_out = static_cast<int8_t*>(score);
  p.offs = static_cast<int32_t*>(scratch);
  p.bsum = reinterpret_cast<int2*>(static_cast<int32_t*>(scratch) + 2 * static_cast<size_t>(p.n));
  cudaError_t e;
  const int grid = grid_for(p.n, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.chunk = (p.n + grid - 1) / grid;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(upload_score_kernel, dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
