// Consensus vote for Hopper: Group::makeConsensus (group.cpp:369-526) per
// (job, position), over member rows gathered by index, with each job's
// members split across several CTAs (split-K).
//
// Instantiations of one kernel pair, by bin set (vote_rules.cuh) and
// output:
//   * Bins6 with the epilogue (gc_vote_epilogue) replaces what the JAX
//     package's pallas_vote_gathered (gencore_tpu/core/pallas_vote.py:474)
//     and pallas_vote (:350) compute: the member gather seq_dev[rows_t],
//     the Pallas kernel (_pallas_core :178, its _kernel/_vote_block body
//     and the sentinel pre-pass) and _epilogue_core (:229, through
//     _epilogue_gathered :335): rollback, the dense nibble-packed rows and,
//     with `sparse`, the wire encoding (epilogue.cuh, shared with
//     vote_window.cu), run where each job is decided. Outputs pseq u8
//     [J, ol/2], new_qual u8 [J, ol], diff and minc int32 [J] and the
//     sparse fields. It also takes the place of the refbase assembly
//     gencore_tpu/engine.py:3097 _refbase_combine_fn and the row gather
//     of its result (engine.py:1828): job j's refbase row is row ridx[j]
//     of the window's, read where its bytes lie (the device genome's
//     slice or a host-built row, refbase.cuh, as vote_window.cu reads
//     them); or, without ridx, row j of a [J, L] refbase.
//   * Bins6 alone (gc_vote) writes the vote's four int32 [J, L] arrays
//     (cand_seq, cand_qual, changed, minc_pos), what _pallas_core returns;
//     no path of the port calls it: chip_smoke.py times it as the vote
//     half of the composition the epilogue entry replaced.
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
//   * where the job's rows are finished in the kernel (the epilogue entry,
//     Bins16) the job is decided by one block, since the rollback needs
//     every position: its decided rows wait in shared memory (4 x L
//     bytes) until the job's minc is known;
//   * within a CTA, the slice's row indices and valid flags are read once
//     per batch of blockDim members, and the valid ones compacted into
//     shared memory (ballot + popc prefix), so absent members cost no
//     loads; the member rows are staged with cp.async in chunks of kChunk
//     members, kStages chunks in flight (staging.cuh, shared with
//     vote_window.cu);
//   * one thread per position of a tile of up to 256 positions, the bins
//     in registers;
//   * a job's refbase row read by index (the gathered entry's kSources
//     form, `Ref`) costs a chain of dependent loads, ridx ->
//     (hm, gp, jp) -> the byte, once per job: each step is issued where
//     the members' loads are in flight (after the first flags, after the
//     first staging), so it waits behind them. Every CTA of a split job
//     walks it, since the vote's ref match reads the byte per member.
//     Each form is an instantiation of its own: one kernel for both
//     forms cost the [J, L] form 6 registers, a block per SM and 21% at
//     9,602 jobs of 4 members on an H100 (PERF.md §6). The chain still
//     costs the source form 1-6% at L = 160 and 9% at those 4-member
//     jobs, where little staging is in flight to wait behind.
// Buckets with K <= 64 keep one CTA per job.
//
// Bins6 semantics carried over exactly from the Pallas kernel:
//   * an invalid member, k = 0 included, reads as seq = 255 (SENTINEL),
//     qual = 0, score = 0; the vote's template base is member 0 after that
//     substitution, so a padded job yields sentinel outputs as in JAX
//     (absent members matter only through that template and the sentinel
//     ref-match rule, which one extra add per CTA reproduces: it is
//     idempotent);
//   * the epilogue's template is the raw row row0[j] (seq and qual),
//     whether member 0 is valid or not (pallas_vote's seq[0] of the
//     host-gathered block is row j of its [K*S, L] view);
//   * a stored seq of 255 also zeroes that member's qual and score;
//   * the score is signed int8;
//   * the elections scan bins in the order (0, 1, 2, 4, 8, 15) with
//     `>` on the score and `>=` on the qual sum (later bins win ties), then
//     the virtual empty bin 14 (13 or 14 for the second election);
//   * the ratio test is top_score*rden < rnum*total_score in wrapping int32;
//   * row indices are clamped to [0, N-1], as JAX clamps a gather;
//   * the epilogue's rules are listed in epilogue.cuh.
// Bins16 semantics carried over from K9: members count where valid and
// pos < job_len; the template is member 0's (shifted) row whether valid
// or not; outside the job length the output is the template; row indices
// are clamped to [0, N-1] (K9's take would fill; no caller passes such a
// row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "refbase.cuh"
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
  const int32_t* job_len;  // [J] (Bins16, epilogue)
  const int32_t* row0;     // [J] the epilogue's template rows
  const uint8_t* refbase;  // [J, L], or null: ridx names the rows
  const int32_t* ridx;     // [J] job j's row of `ref`'s Jw rows, or null
  gc_refsrc::RefSrc ref;   // where the rows lie, with ridx
  const uint8_t* qtable;   // [16] or null (epilogue)
  void* out[4];
  gc_epilogue::Wire wire;  // epilogue, sparse; wire.qv null when dense
  int* bad;                // epilogue, sparse: the bucket's escape count
  int* part;               // C > 1: partial accumulators [C][J][fields][L]
  int K, J, L, N, sk, sj, ol, Jw;
  int hi, mod, lo, bsr, rnum, rden;
};

// What a kernel writes: the vote's four arrays (Bins6 alone), the
// epilogue's outputs (Bins6), or K9's rows (Bins16). The last two finish
// each job in one block from its rows in shared memory (4 x L bytes).
enum class Out { kVote, kEpilogue, kK9 };

template <Out O>
constexpr bool kRows = O != Out::kVote;

// Dynamic shared memory of vote_kernel: the staging ring, the compacted
// rows and shifts of one batch, and the job's decided rows until its
// rollback is known.
template <class B>
__host__ __device__ size_t ring_bytes(int L, int T) {
  return static_cast<size_t>(kStages) * kChunk * 3 * (B::kBins == 16 ? L : T);
}

template <class B, Out O>
size_t smem_bytes(int L, int T) {
  return ring_bytes<B>(L, T) + 2 * sizeof(int) * T +
         (kRows<O> ? 4 * static_cast<size_t>(L) : 0);
}

// Where the gathered entry finds job j's refbase row (gc_vote_epilogue
// takes the form its arguments give; the other entries kJob):
//   kJob      row j of refbase [J, L];
//   kSources  row ridx[j] of the window's Jw rows, where it lies
//             (refbase.cuh: the genome slice or the host row); the
//             index clamps to [0, Jw - 1], as JAX clamps a gather.
enum class Ref { kJob, kSources };

// Job j's refbase row by index, found in steps, each a load that depends
// on the one before (ridx, then hm/gp/jp, then the byte): the caller
// issues each where other loads are in flight, so the chain waits behind
// the members' compaction and staging rather than in front of them. The
// steps are block-uniform: once per job, and then each position is one
// coalesced load. kJob needs none of them.
template <Ref R>
struct JobRef {
  int r = 0;                 // the row index (raw until fields())
  int h = -1, g = 0, n = 0;  // hm, gp, jp of row r

  __device__ __forceinline__ void index(const Args& a, int j) {
    if (R == Ref::kSources) r = a.ridx[j];
  }
  __device__ __forceinline__ void fields(const Args& a) {
    if (R == Ref::kJob) return;
    r = clampi(r, 0, a.Jw - 1);
    h = a.ref.hm[r];
    g = a.ref.gp[r];
    n = a.ref.jp[r];
  }
  // byte p of the row (after fields()); kJob reads row j where it is
  __device__ __forceinline__ int byte(const Args& a, size_t jt, int p) const {
    const int L = a.L;
    if (R == Ref::kJob) return a.refbase[jt * L + p];
    return gc_refsrc::ref_byte(gc_refsrc::row_of(a.ref, h, g, n, L), p);
  }
};

// Position p's templates: the vote's (base, qual: Bins6 reads the
// sentinel for an absent member 0; Bins16 member 0's shifted row whether
// valid or not) and the epilogue's (ts, tq: Bins16 the same; Bins6 the
// raw row row0[j]).
template <class B, Out O>
__device__ __forceinline__ void load_template(const Args& a, size_t jt, int p,
                                              int& base, int& qual, int& ts,
                                              int& tq) {
  const size_t at0 = jt * a.sj;
  const size_t r0 = static_cast<size_t>(clampi(a.rows[at0], 0, a.N - 1)) * a.L;
  base = kSentinel;
  qual = 0;
  if (B::kBins == 16) {
    const int x = clampi(a.shifts[at0] + p, 0, a.L - 1);
    base = a.seq[r0 + x];
    qual = a.qual[r0 + x];
    ts = base;
    tq = qual;
    return;
  }
  if (a.valid[at0]) base = a.seq[r0 + p];
  if (O == Out::kEpilogue) {
    const size_t t0 = static_cast<size_t>(clampi(a.row0[jt], 0, a.N - 1)) * a.L;
    ts = a.seq[t0 + p];
    tq = a.qual[t0 + p];
  }
}

// Decide position p of job j: Out::kVote writes the four int32 outputs;
// the others keep the position in `rows` (epilogue.cuh) until the job's
// rollback is known and return its (changed, minc) contribution.
template <class B, Out O>
__device__ __forceinline__ int2 decide_pos(const Args& a, const VoteAcc<B>& acc,
                                           size_t jt, int p, bool live, int rb,
                                           int out_base, int ts, int tq,
                                           int jl, uint8_t* rows) {
  const int L = a.L;
  const VoteOut o = gc_vote_rules::vote_decide<B>(
      acc, out_base, rb, rb != 0, a.hi, a.mod, a.lo, a.bsr, a.rnum, a.rden);
  if (O == Out::kVote) {
    if (live) {
      const size_t at = jt * L + p;
      static_cast<int32_t*>(a.out[0])[at] = o.cand_seq;
      static_cast<int32_t*>(a.out[1])[at] = o.cand_qual;
      static_cast<int32_t*>(a.out[2])[at] = o.changed;
      static_cast<int32_t*>(a.out[3])[at] = o.minc_pos;
    }
    return make_int2(0, 0);
  }
  if (!live) return make_int2(0, 0);
  return gc_epilogue::put_position(rows, L, p, p < jl, o, ts, tq);
}

// The job's writes once it is decided: Bins16 its rolled-back rows, the
// epilogue entry the dense rows and the sparse fields (epilogue.cuh).
template <Out O>
__device__ __forceinline__ void finish_job(const Args& a, size_t jt,
                                           uint8_t* rows, int diff, int minc,
                                           gc_epilogue::Slots& slots) {
  const int L = a.L;
  const int n = O == Out::kK9 ? L : a.ol;
  gc_epilogue::rollback(rows, L, n, minc);
  if (O == Out::kK9) {
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      static_cast<uint8_t*>(a.out[0])[jt * L + p] = rows[p];
      static_cast<uint8_t*>(a.out[1])[jt * L + p] = rows[L + p];
    }
  } else {
    gc_epilogue::write_dense(rows, L, n,
                             static_cast<uint8_t*>(a.out[0]) + jt * (n >> 1),
                             static_cast<uint8_t*>(a.out[1]) + jt * n);
    if (a.wire.qv != nullptr) {
      const int nbad = gc_epilogue::encode_sparse(rows, L, n, a.qtable, slots,
                                                  a.wire, jt, diff, minc);
      if (threadIdx.x == 0 && nbad) atomicAdd(a.bad, nbad);
    }
  }
  if (threadIdx.x == 0) {
    static_cast<int32_t*>(a.out[2])[jt] = diff;
    static_cast<int32_t*>(a.out[3])[jt] = minc;
  }
  __syncthreads();  // rows are rewritten by the next job
}

// Grid (C, 1, jobs): CTA `rank` = blockIdx.x votes its slice of the
// members of job blockIdx.z (+ gridDim.z ...) over every tile; with C = 1
// it decides, else it writes its partial accumulators for decide_kernel.
template <class B, Out O, Ref R>
__global__ void __launch_bounds__(kMaxThreads) vote_kernel(const Args a) {
  constexpr bool kFull = B::kBins == 16;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int warp_cnt[kMaxThreads / 32];
  __shared__ gc_epilogue::Slots slots;

  const int C = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  const int T = static_cast<int>(blockDim.x);
  const int t = static_cast<int>(threadIdx.x);
  const int L = a.L;
  uint8_t* ring = smem;
  int* crow = reinterpret_cast<int*>(smem + ring_bytes<B>(L, T));
  int* cshift = crow + T;
  uint8_t* rows = reinterpret_cast<uint8_t*>(cshift + T);  // 4 x L

  const int slice = (a.K + C - 1) / C;
  const int k_begin = min(rank * slice, a.K);
  const int k_end = min(k_begin + slice, a.K);
  const int ntiles = (L + T - 1) / T;

  for (int j = blockIdx.z; j < a.J; j += gridDim.z) {
    const size_t jt = static_cast<size_t>(j);
    const int jl = kRows<O> ? a.job_len[j] : L;
    // every CTA of the job needs the refbase byte: the vote's ref match
    // (VoteAcc::add) reads it per member, not only the decision. Read by
    // index, its index goes in flight here, the row's sources once the
    // first members' flags are in, its byte behind the first staging.
    JobRef<R> ref;
    ref.index(a, j);
    bool have_fields = R == Ref::kJob;
    int diff = 0, minc = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int p0 = tile * T;
      const int p = p0 + t;
      const bool live = p < L;
      const int seg = kFull ? 0 : p0;  // Bins16 stages whole rows (shifts)
      const int W = kFull ? L : min(T, L - p0);
      int rb = R == Ref::kJob && live ? ref.byte(a, jt, p) : 0;
      bool have_rb = R == Ref::kJob;
      auto refbase_byte = [&]() {
        if (!have_fields) ref.fields(a);
        if (!have_rb && live) rb = ref.byte(a, jt, p);
        have_fields = have_rb = true;
      };

      // the template loads go in flight first
      int out_base = kSentinel, tqual = 0, ts = 0, tq = 0;
      if (C == 1 && live) load_template<B, O>(a, jt, p, out_base, tqual, ts, tq);

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
          if (!have_fields) {  // the index is in by now
            ref.fields(a);
            have_fields = true;
          }
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
          refbase_byte();  // its load waits behind the staging's
          const bool has_ref = rb != 0;
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
      refbase_byte();  // a slice of no members
      // Bins6: absent members read as sentinels (idempotent, so once)
      if (!kFull && any_absent) acc.add(kSentinel, 0, 0, rb, rb != 0, a.hi);

      if (C > 1) {
        if (live)
          acc.store(a.part + (static_cast<size_t>(rank) * a.J + j) *
                                 VoteAcc<B>::kFields * L + p, L);
        continue;
      }
      const int2 d = decide_pos<B, O>(a, acc, jt, p, live, rb, out_base, ts,
                                      tq, jl, rows);
      if (kRows<O>) gc_epilogue::count_block(d, diff, minc);
    }
    if (C == 1 && kRows<O>) finish_job<O>(a, jt, rows, diff, minc, slots);
  }
}

// The second pass with C > 1, one block of 32 x C threads per job (and,
// for the vote alone, per 32-position chunk): warp g reads rank g's
// partials of 32 positions (coalesced) into shared memory, warp 0 merges
// the C of them and decides: the ranks are read in parallel, where one
// thread per position reading them one after another took ~21 us per
// launch at C = 16 on an H100 (PERF.md §6).
template <class B, Out O, Ref R>
__global__ void __launch_bounds__(32 * 16) decide_kernel(const Args a, int C) {
  constexpr int F = VoteAcc<B>::kFields;
  extern __shared__ __align__(16) uint8_t dsmem[];
  int* xch = reinterpret_cast<int*>(dsmem);             // [C][F][32]
  uint8_t* rows = dsmem + sizeof(int) * C * F * 32;     // 4 x L
  __shared__ int job_diff, job_minc;
  __shared__ gc_epilogue::Slots slots;
  const int L = a.L;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int g = static_cast<int>(threadIdx.x) >> 5;
  const int nchunks = (L + 31) / 32;
  for (int j = blockIdx.z; j < a.J; j += gridDim.z) {
    const size_t jt = static_cast<size_t>(j);
    const int jl = kRows<O> ? a.job_len[j] : L;
    JobRef<R> ref;
    ref.index(a, j);
    ref.fields(a);
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
        int rb = 0, out_base = kSentinel, tqual = 0, ts = 0, tq = 0;
        if (live) {
          rb = ref.byte(a, jt, p);
          load_template<B, O>(a, jt, p, out_base, tqual, ts, tq);
        }
        const int2 d = decide_pos<B, O>(a, acc, jt, p, live, rb, out_base, ts,
                                        tq, jl, rows);
        if (kRows<O>) gc_epilogue::count_warp(d, diff, minc);
      }
      __syncthreads();  // xch is rewritten by the next chunk
    }
    if (kRows<O>) {
      if (threadIdx.x == 0) {
        job_diff = diff;
        job_minc = minc;
      }
      __syncthreads();
      finish_job<O>(a, jt, rows, job_diff, job_minc, slots);
    }
  }
}

template <class B, Out O, Ref R = Ref::kJob>
int launch(const Args& a, int split, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (O == Out::kEpilogue && a.wire.qv != nullptr) {
    if (a.bad == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaMemsetAsync(a.bad, 0, sizeof(int), st);  // also when J == 0
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.J <= 0 || a.L <= 0) return 0;
  if (a.K <= 0 || a.N <= 0 || (a.L & 15) || split < 1 || split > 16 ||
      (split > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const gc_refsrc::RefSrc& s = a.ref;
  if (R == Ref::kJob ? a.refbase == nullptr || a.Jw != a.J
                     : a.refbase != nullptr || a.ridx == nullptr ||
                           a.Jw < 1 || s.genome == nullptr ||
                           s.gp == nullptr || s.hm == nullptr ||
                           s.jp == nullptr || s.hr == nullptr ||
                           s.G < a.L || s.nh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (O == Out::kEpilogue &&
      (a.ol < 2 || a.ol > a.L || (a.ol & 1) ||
       (a.wire.qv != nullptr && a.ol > 256)))
    return static_cast<int>(cudaErrorInvalidValue);
  int T = ((a.L + 31) / 32) * 32;
  if (T > kMaxThreads) T = kMaxThreads;
  const int C = split < a.K ? split : a.K;
  const int gz = a.J < 65535 ? a.J : 65535;
  const size_t smem = smem_bytes<B, O>(a.L, T);
  e = cudaFuncSetAttribute(vote_kernel<B, O, R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  vote_kernel<B, O, R><<<dim3(C, 1, gz), T, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || C == 1) return static_cast<int>(e);
  const size_t dsmem = sizeof(int) * C * VoteAcc<B>::kFields * 32 +
                       (kRows<O> ? 4 * static_cast<size_t>(a.L) : 0);
  e = cudaFuncSetAttribute(decide_kernel<B, O, R>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dsmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // a job whose rows are finished here is decided in one block (its
  // rollback needs every position)
  const int gx = kRows<O> ? 1 : (a.L + 31) / 32;
  decide_kernel<B, O, R><<<dim3(gx, 1, gz), 32 * C, dsmem, st>>>(a, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `split` CTAs per job; with split > 1, part is int32 scratch of
// [split, J, fields, L] (fields = 27 for gc_vote and gc_vote_epilogue, 67
// for gc_vote_full) and a second kernel decides.
//
// The gathered vote with its epilogue: seq/qual u8 [N, L], score i8 [N, L]
// (16-byte aligned, L % 16 == 0), rows i32 [K, J] (clamped to [0, N-1]),
// row0 i32 [J] (the templates, clamped), valid u8 [K, J], job_len i32
// [J], qtable u8 [16] or null; job j's refbase row is, without ridx, row
// j of refbase u8 [J, L] (Jw = J), else (refbase null) row
// clamp(ridx[j], 0, Jw - 1) (ridx i32 [J]) of the window's rows where
// they lie: genome u8 [G] (G >= L), gp, hm, jp i32 [Jw], hr u8 [nh, L]
// (nh >= 1; see refbase.cuh); outputs pseq u8
// [J, ol/2], new_qual u8 [J, ol], diff, minc i32 [J] (2 <= ol <= L, ol
// even) and, when qv is not null (ol <= 256), the sparse fields qv u8
// [J, 10] (with a qtable [J, 5]), qs u8 [J, 10], nr u8 [J], sp u8 [J, 4],
// sb u8 [J, 2], nd u8 [J], df, mc int16 [J] and bad i32 [1] (zeroed here).
extern "C" int gc_vote_epilogue(
    const void* seq, const void* qual, const void* score, const void* rows,
    const void* row0, const void* valid, const void* job_len,
    const void* refbase, const void* ridx, const void* genome,
    const void* gp, const void* hm, const void* jp, const void* hr,
    const void* qtable, void* pseq, void* new_qual, void* diff, void* minc,
    void* qv, void* qs, void* nr, void* sp, void* sb, void* nd, void* df,
    void* mc, void* bad, int K, int J, int L, int N, int ol, int Jw, int G,
    int nh, int hi, int mod, int lo, int bsr, int rnum, int rden, int split,
    void* part, void* stream) {
  Args a = {};
  a.seq = static_cast<const uint8_t*>(seq);
  a.qual = static_cast<const uint8_t*>(qual);
  a.score = static_cast<const int8_t*>(score);
  a.rows = static_cast<const int32_t*>(rows);
  a.row0 = static_cast<const int32_t*>(row0);
  a.valid = static_cast<const uint8_t*>(valid);
  a.job_len = static_cast<const int32_t*>(job_len);
  a.refbase = static_cast<const uint8_t*>(refbase);
  a.ridx = static_cast<const int32_t*>(ridx);
  a.ref.genome = static_cast<const uint8_t*>(genome);
  a.ref.gp = static_cast<const int32_t*>(gp);
  a.ref.hm = static_cast<const int32_t*>(hm);
  a.ref.jp = static_cast<const int32_t*>(jp);
  a.ref.hr = static_cast<const uint8_t*>(hr);
  a.ref.G = G;
  a.ref.nh = nh;
  a.qtable = static_cast<const uint8_t*>(qtable);
  a.out[0] = pseq;
  a.out[1] = new_qual;
  a.out[2] = diff;
  a.out[3] = minc;
  a.wire.qv = static_cast<uint8_t*>(qv);
  a.wire.qs = static_cast<uint8_t*>(qs);
  a.wire.nr = static_cast<uint8_t*>(nr);
  a.wire.sp = static_cast<uint8_t*>(sp);
  a.wire.sb = static_cast<uint8_t*>(sb);
  a.wire.nd = static_cast<uint8_t*>(nd);
  a.wire.df = static_cast<uint8_t*>(df);
  a.wire.mc = static_cast<uint8_t*>(mc);
  a.bad = static_cast<int*>(bad);
  a.part = static_cast<int*>(part);
  a.K = K; a.J = J; a.L = L; a.N = N; a.sk = J; a.sj = 1; a.ol = ol;
  a.Jw = Jw;
  a.hi = hi; a.mod = mod; a.lo = lo; a.bsr = bsr; a.rnum = rnum; a.rden = rden;
  if (ridx != nullptr)
    return launch<Bins6, Out::kEpilogue, Ref::kSources>(a, split, stream);
  return launch<Bins6, Out::kEpilogue, Ref::kJob>(a, split, stream);
}

// The vote alone, as gc_vote_epilogue without row0, job_len and qtable;
// outputs cand_seq, cand_qual, changed, minc_pos i32 [J, L].
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
  a.K = K; a.J = J; a.L = L; a.N = N; a.sk = J; a.sj = 1; a.Jw = J;
  a.hi = hi; a.mod = mod; a.lo = lo; a.bsr = bsr; a.rnum = rnum; a.rden = rden;
  return launch<Bins6, Out::kVote>(a, split, stream);
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
  a.K = K; a.J = J; a.L = L; a.N = N; a.sk = 1; a.sj = K; a.Jw = J;
  a.hi = hi; a.mod = mod; a.lo = lo; a.bsr = bsr; a.rnum = rnum; a.rden = rden;
  return launch<Bins16, Out::kK9>(a, split, stream);
}
