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
// rows a bit mask marks as scored (engine.py:3054-3065; K6). The port ran
// it as ~240 plain-torch launches after 16 host-to-device copies
// (engine._upload_score_plain, now this kernel's twin).
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
//     bit 25 | scored bit 26; the mate mate16[r] (clamped) rebuilt as
//     above; position j of the overlap (my_start <= j < my_start +
//     cmp_len, j < length) meets the mate's column (j + mate_start -
//     my_start) mod L: a match scores q2s((q + pq) / 2) + 4, a mismatch
//     q2s(q - pq) - 3 for the row that wins (q > pq, the left mate winning
//     ties) and 0 for the other, and the scored row's qual becomes
//     max(q - pq, 0); elsewhere q2s(q); unscored rows score s_mod;
//   * with no_overlap, meta is the little-order bit mask of scored rows:
//     a scored row scores q2s(q), the others s_mod; quals stay.
//
// Design: one cooperative launch, persistent blocks. Phase 1: each block
// scans the seq and qual edit counts of a chunk of rows (local exclusive
// offsets) and publishes the chunk's totals; one grid barrier; each block
// then scans the chunks' totals into shared memory, so the offset of any
// row is its local offset plus its chunk's. Phase 2: a warp per row (rows
// by stride) rebuilds the row into shared memory, rebuilds its mate where
// the row is scored (from the staging again, which costs a few hundred
// bytes of L2 reads instead of a second barrier and a scratch copy of the
// matrices), scores, and writes the three rows; a lane per position,
// consecutive lanes on consecutive bytes. Edits land in parallel: lane c
// holds edit c and writes it unless a later edit names the same position.
//
// Bound: bytes. The outputs are 3 bytes per (row, position) against a
// staging of a few bytes per row, so the bound is the outputs' write and
// the staging's read at 3.35 TB/s; the integer work per position is a few
// dozen operations. The first version is simple: no vector stores, the
// mate rebuilt rather than shared.

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
constexpr int kMaxGrid = 2048;
constexpr int kCap = 12;       // edits per row (engine._SPARSE_SEQ_CAP, _QUAL_CAP)
constexpr unsigned kAll = 0xffffffffu;

enum Flags {
  kMode2 = 1,
  kSedit = 2,
  kQdense = 4,
  kQedit = 8,
  kConstLens = 16,
  kGenome = 32,
  kNoOverlap = 64
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
  const uint16_t* mate16;
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

// Edits c < min(cnt, kCap) of a row, at flat offset off: lane c holds edit
// c and writes it unless a later edit names the same position (the later
// edit wins); positions >= w match nothing.
__device__ __forceinline__ void apply_edits(uint8_t* row, int cnt, int off, const uint8_t* pos,
                                            const uint8_t* val, int Ef, int w, int lane) {
  const int m = cnt < kCap ? cnt : kCap;
  int pp = -1;
  uint8_t vv = 0;
  if (lane < m) {
    const int idx = clampi(off + lane, 0, Ef - 1);
    pp = pos[idx];
    vv = val[idx];
    if (pp >= w) pp = -1;
  }
  bool last = pp >= 0;
#pragma unroll
  for (int c = 1; c < kCap; ++c) {
    const int later = __shfl_down_sync(kAll, pp, c);
    if (lane + c < m && later == pp) last = false;
  }
  if (last) row[pp] = vv;
}

// Row r rebuilt into shared memory sq / ql [L] by the calling warp;
// returns its length. bpre: each chunk's exclusive offsets.
__device__ __forceinline__ int rebuild(const Params& p, const int2* bpre, int r, uint8_t* sq,
                                       uint8_t* ql, int lane) {
  const int w = p.w;
  const int L = p.L;
  const int nrows = p.nd + ((p.flags & kGenome) ? p.ns : 0);
  const int s = clampi(p.src[r], 0, nrows - 1);
  const bool mode2 = (p.flags & kMode2) != 0;
  const uint8_t* drow = nullptr;
  const uint8_t* grow = nullptr;
  if (s < p.nd) {
    drow = p.sd + static_cast<size_t>(s) * p.bw;
  } else {
    const int hi_start = p.G - w > 0 ? p.G - w : 0;
    grow = p.genome + clampi(p.gsl[s - p.nd], 0, hi_start);
  }
  const bool zero_row = mode2 && s == 0;
  const int qb = p.base[r];
  const uint8_t* qrow = nullptr;
  if (p.flags & kQdense) {
    const int qs = p.q_src[r];
    if (qs > 0) qrow = p.qd + static_cast<size_t>(clampi(qs - 1, 0, p.nq - 1)) * p.qw;
  }
  for (int j = lane; j < L; j += 32) {
    uint8_t sv = 0, qv = 0;
    if (j < w) {
      if (grow != nullptr) {
        sv = grow[j];
      } else if (mode2) {
        sv = zero_row ? 0 : static_cast<uint8_t>(1u << ((drow[j >> 2] >> (6 - 2 * (j & 3))) & 3));
      } else {
        const int b = drow[j >> 1];
        sv = static_cast<uint8_t>((j & 1) ? (b & 15) : (b >> 4));
      }
      qv = qrow != nullptr ? qrow[j] : static_cast<uint8_t>(qb);
    }
    sq[j] = sv;
    ql[j] = qv;
  }
  __syncwarp();
  const int chunk = r / p.chunk;
  if (p.flags & kSedit)
    apply_edits(sq, p.scnt[r], __ldcg(p.offs + r) + bpre[chunk].x, p.epos, p.ecode, p.E, w, lane);
  if (p.flags & kQedit)
    apply_edits(ql, p.qcnt[r], __ldcg(p.offs + p.n + r) + bpre[chunk].y, p.qpos, p.qval, p.Eq, w,
                lane);
  __syncwarp();
  const int len = row_len(p, r);
  for (int j = lane; j < L; j += 32) {
    if (j >= len) {
      sq[j] = 0;
      ql[j] = 0;
    }
  }
  __syncwarp();
  return len;
}

__global__ void __launch_bounds__(kThreads) upload_score_kernel(const Params p) {
  __shared__ int2 bpre[kMaxGrid];
  __shared__ __align__(16) uint8_t rows[kWarps][4][kMaxL];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n = p.n;
  const int L = p.L;

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

  // phase 2: a warp per row
  uint8_t* const own_s = rows[warp][0];
  uint8_t* const own_q = rows[warp][1];
  const bool no_ov = (p.flags & kNoOverlap) != 0;
  for (int r = static_cast<int>(blockIdx.x) * kWarps + warp; r < n;
       r += static_cast<int>(gridDim.x) * kWarps) {
    const int len = rebuild(p, bpre, r, own_s, own_q, lane);
    uint8_t* const so = p.seq_out + static_cast<size_t>(r) * L;
    uint8_t* const qo = p.qual_out + static_cast<size_t>(r) * L;
    int8_t* const co = p.score_out + static_cast<size_t>(r) * L;
    if (no_ov) {
      const uint8_t* bits = static_cast<const uint8_t*>(p.meta);
      const bool scored = (bits[r >> 3] >> (r & 7)) & 1;
      for (int j = lane; j < L; j += 32) {
        const int q = own_q[j];
        so[j] = own_s[j];
        qo[j] = static_cast<uint8_t>(q);
        co[j] = static_cast<int8_t>(scored ? q2s(q, p) : p.s_mod);
      }
      continue;
    }
    const unsigned m = static_cast<const uint32_t*>(p.meta)[r];
    const bool scored = (m >> 26) & 1u;
    if (!scored) {
      for (int j = lane; j < L; j += 32) {
        so[j] = own_s[j];
        qo[j] = own_q[j];
        co[j] = static_cast<int8_t>(p.s_mod);
      }
      continue;
    }
    const int ms = m & 0xFF;
    const int ts = (m >> 8) & 0xFF;
    const int cl = (m >> 16) & 0x1FF;
    const bool left = (m >> 25) & 1u;
    const int mate = clampi(p.mate16[r], 0, n - 1);
    const uint8_t* mate_s = own_s;
    const uint8_t* mate_q = own_q;
    if (mate != r) {
      (void)rebuild(p, bpre, mate, rows[warp][2], rows[warp][3], lane);
      mate_s = rows[warp][2];
      mate_q = rows[warp][3];
    }
    const int delta = ((ts - ms) % L + L) % L;
    for (int j = lane; j < L; j += 32) {
      const int sv = own_s[j];
      const int q = own_q[j];
      int k = j + delta;
      if (k >= L) k -= L;
      const int ps = mate_s[k];
      const int pq = mate_q[k];
      const bool in_ov = j >= ms && j < ms + cl && j < len;
      int sc;
      int nq = q;
      if (!in_ov) {
        sc = q2s(q, p);
      } else if (sv == ps) {
        sc = q2s((q + pq) >> 1, p) + 4;
      } else {
        const bool win = q > pq || (left && q == pq);
        sc = win ? q2s(q - pq, p) - 3 : 0;
        nq = q - pq > 0 ? q - pq : 0;
      }
      so[j] = static_cast<uint8_t>(sv);
      qo[j] = static_cast<uint8_t>(nq);
      co[j] = static_cast<int8_t>(sc);
    }
    __syncwarp();  // the mate buffers are read before the next row writes them
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

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = success). `up` is the
// device copy of the staging buffer (core/kernels.upload_score_layout);
// dims (host, kDims ints): kDims, n, w, L, flags (mode2 1, has_sedit 2,
// has_qdense 4, has_qedit 8, const_lens 16, has_genome 32, no_overlap
// 64), nd, bw (bytes per dense row), ns (genome slots), G, E, Eq, nq, qw
// (dense qual rows and their width), hi, mod, lo, s_hi, s_mod, s_lo,
// s_bad, then the byte offsets in `up` of sd, src, scnt, epos, ecode,
// base, q_src, qd, qcnt, qpos, qval, lens16, mate16, meta, gsl and the
// barrier word (zeroed by the host). genome u8 [G] (has_genome) or null;
// outputs seq, qual u8 [n, L] and score i8 [n, L]; scratch i32 [2 n + 2
// kMaxGrid].
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
  if (p.w <= 0 || p.L < p.w || p.L > kMaxL || p.nd <= 0 || p.bw <= 0 ||
      (p.flags & kMode2 ? 4 : 2) * p.bw < p.w || (genome_rows && (p.ns <= 0 || p.G < p.w)) ||
      ((p.flags & kSedit) && p.E <= 0) || ((p.flags & kQedit) && p.Eq <= 0) ||
      ((p.flags & kQdense) && (p.nq <= 0 || p.qw != p.w)) || (genome_rows && genome == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.mate16 = reinterpret_cast<const uint16_t*>(b + off[12]);
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
  int grid = resident_blocks(&e);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int want = (p.n + kWarps - 1) / kWarps;
  if (grid > want) grid = want;
  if (grid > kMaxGrid) grid = kMaxGrid;
  p.chunk = (p.n + grid - 1) / grid;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(upload_score_kernel, dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
