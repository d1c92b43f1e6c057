// Consensus vote for Hopper: Group::makeConsensus (group.cpp:369-526) per
// (job, position), over member rows gathered by index, with each job's
// members split across several CTAs (split-K).
//
// Two instantiations of one kernel pair, by bin set (vote_rules.cuh):
//   * Bins6 (gc_vote) replaces the Pallas kernel of the JAX package,
//     gencore_tpu/core/pallas_vote.py:_pallas_core (its _kernel/_vote_block
//     body and the sentinel pre-pass), and folds in the member gather that
//     the JAX program materializes as seq_dev[rows_t] before the call.
//     Outputs cand_seq, cand_qual, changed, minc_pos, int32 [J, L].
//   * Bins16 (gc_vote_full) is the counterpart of the XLA program K9,
//     gencore_tpu/core/kernels.py:fused_vote_kernel with full_bins=True:
//     member loads at clip(shift + pos, 0, L-1), members counted only at
//     positions below the job length, and the per-job diff/minc sums and
//     rollback (minc > 5) done where the job is decided. Outputs new_seq
//     and new_qual u8 [J, L], diff and minc int32 [J].
//
// What bounds it on this card. Per valid (member, position) the vote must
// read 3 bytes (seq, qual, score) and do ~10 integer operations, so deep
// buckets of few jobs are bound by the bytes and wide buckets of many
// members by integer issue. The first design (one thread per (job,
// position), every member a dependent chain of global loads valid -> row
// -> seq -> qual/score, nothing in flight ahead) gave a deep-pile bucket
// (J = 8..128 jobs of 512..4096 members) only J blocks of serial work:
// 0.15-2% of its bound on an H100. This design:
//   * C CTAs per job (C from K and J in core/vote.py, up to 16): CTA
//     `rank` votes members [rank*ceil(K/C), ...) of the job over all
//     positions of a tile, so a bucket of a few jobs still fills the card;
//   * with C > 1 each CTA writes its partial accumulators (every one a
//     wrapping int32 sum, a max or an or, so any split gives the same
//     bits) to device memory, and decide_kernel merges the C partials of
//     each (job, position), one warp per rank, decides and writes the
//     outputs. A merge into a
//     leader CTA of a thread-block cluster through distributed shared
//     memory was 14-31% slower at the deep-pile shapes in an on-card A/B
//     (PERF.md, PR 3). With C = 1 the CTA decides itself, one launch;
//   * within a CTA, the slice's row indices and valid flags are read once
//     per batch of blockDim members, and the valid ones compacted into
//     shared memory (ballot + popc prefix), so absent members cost no
//     loads; the member rows are staged with cp.async in chunks of kChunk
//     members, kStages chunks in flight (staging.cuh, shared with
//     vote_window.cu);
//   * one thread per position of a tile of up to 256 positions, the bins
//     in registers.
// Buckets with K <= 64 keep one CTA per job.
//
// Bins6 semantics carried over exactly from the Pallas kernel:
//   * an invalid member, k = 0 included, reads as seq = 255 (SENTINEL),
//     qual = 0, score = 0; the template base is member 0 after that
//     substitution, so a padded job yields sentinel outputs as in JAX
//     (absent members matter only through that template and the sentinel
//     ref-match rule, which one extra add per CTA reproduces: it is
//     idempotent);
//   * a stored seq of 255 also zeroes that member's qual and score;
//   * the score is signed int8;
//   * the elections scan bins in the order (0, 1, 2, 4, 8, 15) with
//     `>` on the score and `>=` on the qual sum (later bins win ties), then
//     the virtual empty bin 14 (13 or 14 for the second election);
//   * the ratio test is top_score*rden < rnum*total_score in wrapping int32;
//   * row indices are clamped to [0, N-1], as JAX clamps a gather.
// Bins16 semantics carried over from K9: members count where valid and
// pos < job_len; the template is member 0's (shifted) row whether valid
// or not; outside the job length the output is the template; row indices
// are clamped to [0, N-1] (K9's take would fill; no caller passes such a
// row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"
#include "vote_rules.cuh"

namespace {

using gc_staging::clampi;
using gc_staging::cp_async_commit;
using gc_staging::cp_async_wait;
using gc_staging::stage_rows;
using gc_vote_rules::Bins16;
using gc_vote_rules::Bins6;
using gc_vote_rules::kSentinel;
using gc_vote_rules::VoteAcc;
using gc_vote_rules::VoteOut;

constexpr int kChunk = 16;         // members per shared-memory stage
constexpr int kStages = 3;         // stages in flight
constexpr int kMaxThreads = 256;   // positions per tile

struct Args {
  const uint8_t* seq;
  const uint8_t* qual;
  const int8_t* score;
  const int32_t* rows;     // member k of job j at [k * sk + j * sj]
  const uint8_t* valid;    // same layout
  const int32_t* shifts;   // same layout (Bins16)
  const int32_t* job_len;  // [J] (Bins16)
  const uint8_t* refbase;  // [J, L]
  void* out[4];
  int* part;               // C > 1: partial accumulators [C][J][fields][L]
  int K, J, L, N, sk, sj;
  int hi, mod, lo, bsr, rnum, rden;
};

// Dynamic shared memory of vote_kernel: the staging ring, the compacted
// rows and shifts of one batch, and (Bins16) the job's per-position rows
// until its rollback is known.
template <class B>
__host__ __device__ size_t ring_bytes(int L, int T) {
  return static_cast<size_t>(kStages) * kChunk * 3 * (B::kBins == 16 ? L : T);
}

template <class B>
size_t smem_bytes(int L, int T) {
  return ring_bytes<B>(L, T) + 2 * sizeof(int) * T +
         (B::kBins == 16 ? 4 * static_cast<size_t>(L) : 0);
}

// Member 0's base and qual at position p (the template): Bins6 reads the
// sentinel for an absent member 0; Bins16 reads member 0's shifted row
// whether valid or not.
template <class B>
__device__ __forceinline__ void load_template(const Args& a, size_t at0, int p,
                                              int& base, int& qual) {
  const size_t r0 = static_cast<size_t>(clampi(a.rows[at0], 0, a.N - 1)) * a.L;
  base = kSentinel;
  qual = 0;
  if (B::kBins == 16) {
    const int x = clampi(a.shifts[at0] + p, 0, a.L - 1);
    base = a.seq[r0 + x];
    qual = a.qual[r0 + x];
  } else if (a.valid[at0]) {
    base = a.seq[r0 + p];
  }
}

// Decide position p of job j and write it: Bins6 writes the four int32
// outputs; Bins16 keeps its rows in `rowbuf` (4 x L) until the job's
// rollback is known and returns its (changed, minc) contribution.
template <class B>
__device__ __forceinline__ int2 decide_pos(const Args& a, const VoteAcc<B>& acc,
                                           size_t jt, int p, bool live, int rb,
                                           int out_base, int tqual, int jl,
                                           uint8_t* rowbuf) {
  const int L = a.L;
  const VoteOut o = gc_vote_rules::vote_decide<B>(
      acc, out_base, rb, rb != 0, a.hi, a.mod, a.lo, a.bsr, a.rnum, a.rden);
  if (B::kBins != 16) {
    if (live) {
      const size_t at = jt * L + p;
      static_cast<int32_t*>(a.out[0])[at] = o.cand_seq;
      static_cast<int32_t*>(a.out[1])[at] = o.cand_qual;
      static_cast<int32_t*>(a.out[2])[at] = o.changed;
      static_cast<int32_t*>(a.out[3])[at] = o.minc_pos;
    }
    return make_int2(0, 0);
  }
  // K9: changed only inside the job length; outside it the template
  const bool pv = live && p < jl;
  const int chg = pv ? o.changed : 0;
  if (live) {
    rowbuf[p] = static_cast<uint8_t>(chg ? o.cand_seq : out_base);
    rowbuf[L + p] = static_cast<uint8_t>(pv ? o.cand_qual : tqual);
    rowbuf[2 * L + p] = static_cast<uint8_t>(out_base);
    rowbuf[3 * L + p] = static_cast<uint8_t>(tqual);
  }
  return make_int2(chg, pv ? o.minc_pos : 0);
}

// Bins16: the per-read rollback (group.cpp:538-566) and the job's writes.
template <class B>
__device__ __forceinline__ void finish_job(const Args& a, size_t jt,
                                           const uint8_t* rowbuf, int diff,
                                           int minc) {
  if (B::kBins != 16) return;
  const int L = a.L;
  const int rbk = minc > 5 ? 2 * L : 0;
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    static_cast<uint8_t*>(a.out[0])[jt * L + p] = rowbuf[rbk + p];
    static_cast<uint8_t*>(a.out[1])[jt * L + p] = rowbuf[rbk + L + p];
  }
  if (threadIdx.x == 0) {
    static_cast<int32_t*>(a.out[2])[jt] = diff;
    static_cast<int32_t*>(a.out[3])[jt] = minc;
  }
  __syncthreads();  // rowbuf is rewritten by the next job
}

// Grid (C, 1, jobs): CTA `rank` = blockIdx.x votes its slice of the
// members of job blockIdx.z (+ gridDim.z ...) over every tile; with C = 1
// it decides, else it writes its partial accumulators for decide_kernel.
template <class B>
__global__ void __launch_bounds__(kMaxThreads) vote_kernel(const Args a) {
  constexpr bool kFull = B::kBins == 16;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int warp_cnt[kMaxThreads / 32];

  const int C = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  const int T = static_cast<int>(blockDim.x);
  const int t = static_cast<int>(threadIdx.x);
  const int L = a.L;
  uint8_t* ring = smem;
  int* crow = reinterpret_cast<int*>(smem + ring_bytes<B>(L, T));
  int* cshift = crow + T;
  uint8_t* rowbuf = reinterpret_cast<uint8_t*>(cshift + T);  // 4 x L

  const int slice = (a.K + C - 1) / C;
  const int k_begin = min(rank * slice, a.K);
  const int k_end = min(k_begin + slice, a.K);
  const int ntiles = (L + T - 1) / T;

  for (int j = blockIdx.z; j < a.J; j += gridDim.z) {
    const size_t jt = static_cast<size_t>(j);
    const int jl = kFull ? a.job_len[j] : L;
    int diff = 0, minc = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int p0 = tile * T;
      const int p = p0 + t;
      const bool live = p < L;
      const int seg = kFull ? 0 : p0;  // Bins16 stages whole rows (shifts)
      const int W = kFull ? L : min(T, L - p0);
      const int rb = live ? a.refbase[jt * L + p] : 0;
      const bool has_ref = rb != 0;

      // the template loads go in flight first
      int out_base = kSentinel, tqual = 0;
      if (C == 1 && live) load_template<B>(a, jt * a.sj, p, out_base, tqual);

      VoteAcc<B> acc;
      acc.init();
      bool any_absent = false;
      const bool votes = live && (!kFull || p < jl);
      // Bins16: no member counts at or past the job length
      if (!kFull || p0 < jl) {
        for (int kb = k_begin; kb < k_end; kb += T) {
          // compact the valid members of [kb, kb + T)
          const int k = kb + t;
          bool v = false;
          int r = 0, sh = 0;
          if (k < k_end) {
            const size_t at = static_cast<size_t>(k) * a.sk + jt * a.sj;
            v = a.valid[at] != 0;
            if (v) {
              r = clampi(a.rows[at], 0, a.N - 1);
              if (kFull) sh = a.shifts[at];
            }
          }
          const unsigned bal = __ballot_sync(0xffffffffu, v);
          if ((t & 31) == 0) warp_cnt[t >> 5] = __popc(bal);
          __syncthreads();
          int pre = 0, nv = 0;
          for (int w = 0; w < (T >> 5); ++w) {
            const int c = warp_cnt[w];
            if (w < (t >> 5)) pre += c;
            nv += c;
          }
          if (v) {
            const int i = pre + __popc(bal & ((1u << (t & 31)) - 1u));
            crow[i] = r;
            cshift[i] = sh;
          }
          any_absent |= nv < min(T, k_end - kb);
          __syncthreads();

          // the compacted members, kChunk at a time, kStages chunks in flight
          const int nchunks = (nv + kChunk - 1) / kChunk;
          const int stage_bytes = kChunk * 3 * W;
          auto issue = [&](int c) {
            if (c < nchunks) {
              const int* cr = crow + c * kChunk;
              stage_rows(ring + (c % kStages) * stage_bytes, a.seq, a.qual,
                         a.score, [=](int mi) { return cr[mi]; },
                         min(nv - c * kChunk, kChunk), L, seg, W);
            }
            cp_async_commit();
          };
#pragma unroll
          for (int c = 0; c < kStages - 1; ++c) issue(c);
          for (int c = 0; c < nchunks; ++c) {
            issue(c + kStages - 1);  // refills the buffer voted at c - 1
            cp_async_wait<kStages - 1>();
            __syncthreads();
            const uint8_t* buf = ring + (c % kStages) * stage_bytes;
            const int m = min(nv - c * kChunk, kChunk);
            if (votes) {
#pragma unroll
              for (int mi = 0; mi < kChunk; ++mi) {
                if (mi >= m) break;
                const int x = kFull ? clampi(cshift[c * kChunk + mi] + p, 0, L - 1)
                                    : p - seg;
                const int s = buf[(mi * 3 + 0) * W + x];
                const int q = buf[(mi * 3 + 1) * W + x];
                const int sc = static_cast<int8_t>(buf[(mi * 3 + 2) * W + x]);
                acc.add(s, q, sc, rb, has_ref, a.hi);
              }
            }
            __syncthreads();
          }
          cp_async_wait<0>();
        }
      }
      // Bins6: absent members read as sentinels (idempotent, so once)
      if (!kFull && any_absent) acc.add(kSentinel, 0, 0, rb, has_ref, a.hi);

      if (C > 1) {
        if (live)
          acc.store(a.part + (static_cast<size_t>(rank) * a.J + j) *
                                 VoteAcc<B>::kFields * L + p, L);
        continue;
      }
      const int2 d = decide_pos<B>(a, acc, jt, p, live, rb, out_base, tqual,
                                   jl, rowbuf);
      if (kFull) {
        diff += __syncthreads_count(d.x != 0);
        minc += __syncthreads_count(d.y > 0) - __syncthreads_count(d.y < 0);
      }
    }
    if (C == 1) finish_job<B>(a, jt, rowbuf, diff, minc);
  }
}

// The second pass with C > 1, one block of 32 x C threads per job (and,
// for Bins6, per 32-position chunk): warp g reads rank g's partials of 32
// positions (coalesced) into shared memory, warp 0 merges the C of them
// and decides: the ranks are read in parallel, where one thread per
// position reading them one after another took ~21 us per launch at
// C = 16 on an H100 (PERF.md, PR 3).
template <class B>
__global__ void __launch_bounds__(32 * 16) decide_kernel(const Args a, int C) {
  constexpr bool kFull = B::kBins == 16;
  constexpr int F = VoteAcc<B>::kFields;
  extern __shared__ __align__(16) uint8_t dsmem[];
  int* xch = reinterpret_cast<int*>(dsmem);             // [C][F][32]
  uint8_t* rowbuf = dsmem + sizeof(int) * C * F * 32;   // Bins16: 4 x L
  __shared__ int job_diff, job_minc;
  const int L = a.L;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int g = static_cast<int>(threadIdx.x) >> 5;
  const int nchunks = (L + 31) / 32;
  for (int j = blockIdx.z; j < a.J; j += gridDim.z) {
    const size_t jt = static_cast<size_t>(j);
    const int jl = kFull ? a.job_len[j] : L;
    int diff = 0, minc = 0;
    for (int ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
      const int p = ch * 32 + lane;
      const bool live = p < L;
      VoteAcc<B> acc;
      acc.init();
      if (live) acc.merge(a.part + (static_cast<size_t>(g) * a.J + j) * F * L + p, L);
      acc.store(xch + g * F * 32 + lane, 32);
      __syncthreads();
      if (g == 0) {
        for (int r = 1; r < C; ++r) acc.merge(xch + r * F * 32 + lane, 32);
        int rb = 0, out_base = kSentinel, tqual = 0;
        if (live) {
          rb = a.refbase[jt * L + p];
          load_template<B>(a, jt * a.sj, p, out_base, tqual);
        }
        const int2 d = decide_pos<B>(a, acc, jt, p, live, rb, out_base, tqual,
                                     jl, rowbuf);
        if (kFull) {
          diff += __popc(__ballot_sync(0xffffffffu, d.x != 0));
          minc += __popc(__ballot_sync(0xffffffffu, d.y > 0)) -
                  __popc(__ballot_sync(0xffffffffu, d.y < 0));
        }
      }
      __syncthreads();  // xch is rewritten by the next chunk
    }
    if (kFull) {
      if (threadIdx.x == 0) {
        job_diff = diff;
        job_minc = minc;
      }
      __syncthreads();
      finish_job<B>(a, jt, rowbuf, job_diff, job_minc);
    }
  }
}

template <class B>
int launch(const Args& a, int split, void* stream) {
  if (a.J <= 0 || a.L <= 0) return 0;
  if (a.K <= 0 || a.N <= 0 || (a.L & 15) || split < 1 || split > 16 ||
      (split > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int T = ((a.L + 31) / 32) * 32;
  if (T > kMaxThreads) T = kMaxThreads;
  const int C = split < a.K ? split : a.K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gz = a.J < 65535 ? a.J : 65535;
  const size_t smem = smem_bytes<B>(a.L, T);
  cudaError_t e = cudaFuncSetAttribute(
      vote_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  vote_kernel<B><<<dim3(C, 1, gz), T, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || C == 1) return static_cast<int>(e);
  const size_t dsmem = sizeof(int) * C * VoteAcc<B>::kFields * 32 +
                       (B::kBins == 16 ? 4 * static_cast<size_t>(a.L) : 0);
  e = cudaFuncSetAttribute(decide_kernel<B>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dsmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // Bins16 decides a job in one block (its rollback needs every position)
  const int gx = B::kBins == 16 ? 1 : (a.L + 31) / 32;
  decide_kernel<B><<<dim3(gx, 1, gz), 32 * C, dsmem, st>>>(a, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `split` CTAs per job; with split > 1, part is int32 scratch of
// [split, J, fields, L] (fields = 27 for gc_vote, 67 for gc_vote_full)
// and a second kernel decides.
// seq/qual u8 [N, L], score i8 [N, L] (16-byte aligned, L % 16 == 0),
// rows i32 [K, J] (clamped to [0, N-1]), valid u8 [K, J], refbase u8
// [J, L]; outputs cand_seq, cand_qual, changed, minc_pos i32 [J, L].
extern "C" int gc_vote(const void* seq, const void* qual, const void* score,
                       const void* rows, const void* valid,
                       const void* refbase, void* cand_seq, void* cand_qual,
                       void* changed, void* minc, int K, int J, int L, int N,
                       int hi, int mod, int lo, int bsr, int rnum, int rden,
                       int split, void* part, void* stream) {
  Args a = {};
  a.seq = static_cast<const uint8_t*>(seq);
  a.qual = static_cast<const uint8_t*>(qual);
  a.score = static_cast<const int8_t*>(score);
  a.rows = static_cast<const int32_t*>(rows);
  a.valid = static_cast<const uint8_t*>(valid);
  a.refbase = static_cast<const uint8_t*>(refbase);
  a.out[0] = cand_seq;
  a.out[1] = cand_qual;
  a.out[2] = changed;
  a.out[3] = minc;
  a.part = static_cast<int*>(part);
  a.K = K; a.J = J; a.L = L; a.N = N; a.sk = J; a.sj = 1;
  a.hi = hi; a.mod = mod; a.lo = lo; a.bsr = bsr; a.rnum = rnum; a.rden = rden;
  return launch<Bins6>(a, split, stream);
}

// The K9 vote (full_bins=True): rows, shifts i32 and valid u8 [J, K],
// job_len i32 [J], the rest as gc_vote; outputs new_seq, new_qual u8
// [J, L], diff, minc i32 [J].
extern "C" int gc_vote_full(const void* seq, const void* qual,
                            const void* score, const void* rows,
                            const void* shifts, const void* valid,
                            const void* job_len, const void* refbase,
                            void* new_seq, void* new_qual, void* diff,
                            void* minc, int K, int J, int L, int N, int hi,
                            int mod, int lo, int bsr, int rnum, int rden,
                            int split, void* part, void* stream) {
  Args a = {};
  a.seq = static_cast<const uint8_t*>(seq);
  a.qual = static_cast<const uint8_t*>(qual);
  a.score = static_cast<const int8_t*>(score);
  a.rows = static_cast<const int32_t*>(rows);
  a.shifts = static_cast<const int32_t*>(shifts);
  a.valid = static_cast<const uint8_t*>(valid);
  a.job_len = static_cast<const int32_t*>(job_len);
  a.refbase = static_cast<const uint8_t*>(refbase);
  a.out[0] = new_seq;
  a.out[1] = new_qual;
  a.out[2] = diff;
  a.out[3] = minc;
  a.part = static_cast<int*>(part);
  a.K = K; a.J = J; a.L = L; a.N = N; a.sk = 1; a.sj = K;
  a.hi = hi; a.mod = mod; a.lo = lo; a.bsr = bsr; a.rnum = rnum; a.rden = rden;
  return launch<Bins16>(a, split, stream);
}
