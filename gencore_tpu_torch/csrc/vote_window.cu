// The whole-window consensus vote for Hopper, fused: per job, the refbase
// row, the vote of Group::makeConsensus (group.cpp:369-526) over its
// members, the per-read rollback (group.cpp:538-566), nibble packing and
// the sparse wire encoding, written straight into the window's flat
// download buffer.
//
// Replaces, on the JAX side, the whole of gencore_tpu/core/pallas_vote.py's
// _pallas_window_all (:390): the refbase assembly (:404-410, a genome
// dynamic_slice per contiguous job, else a host-built row), and for each
// k-class the member gather seq_dev[rows_t], the Pallas kernel
// (_pallas_core, _kernel/_vote_block) and _epilogue_core(sparse=True,
// qtable), plus the cross-class wire concat.
//
// Bound. Per (member, position) the kernel must read 3 bytes (seq, qual,
// score) and do ~10 integer operations (bin match, count, score sum, qual
// sum, top qual, total, ref match); per job it writes ~27 sparse bytes
// plus the 1.5 B/position dense fallback, and per job of the window one
// refbase row. Against the H100's 3.35 TB/s and ~16.7 T int32 op/s (132
// SMs x 64 lanes x 1.98 GHz), large member counts are bound by integer
// issue, small ones by the bytes. On an H100 SXM (chip_smoke.py phases 2b
// and 5) the kernel reaches 10-17% of that bound: what the bound leaves
// out dominates at a few members per job, namely the per-position
// decision and epilogue (several times the member work at 3 members) and
// each block's latency chain (job row, staged members, barriers).
//
// Design:
//   * one block per job, one thread per position (L <= 256), so every
//     per-row reduction of the epilogue is a block reduction and nothing
//     round-trips through device memory (epilogue.cuh, shared with
//     vote.cu);
//   * the refbase row is built where it is read: the genome slice (start
//     as dynamic_slice takes it: a negative one counts once from the end,
//     then it clamps to [0, G - L]; zero at and beyond the job's length)
//     or the host row (index clamped to the rows); block g also writes refbase rows g,
//     g + Jt, ... of the window for the buckets that the window does not
//     take. Its inputs come up with the job table in one copy;
//   * the loop runs to the job's member count, not to the class size K;
//     absent members matter only as the sentinel template of an empty job
//     and through the sentinel ref-match rule, which one extra add()
//     reproduces;
//   * a job's members are the contiguous rows base..base+count-1 (clamped
//     to the matrix as a JAX gather clamps), so the block stages them into
//     shared memory with cp.async, 16 B per thread, in chunks of kChunk
//     members and two buffers: chunk c+1 is in flight while chunk c is
//     voted;
//   * the class's escape count `bad` is an integer atomicAdd (order-free,
//     so deterministic); the last block to finish (a ticket counter)
//     writes the per-class counts into the buffer.
//
// Exact semantics carried over (each is a byte of the wire buffer): the
// vote rules of vote_rules.cuh, Bins6 (see vote.cu for the list), with the
// template row at the job's clamped base row (seq_dev/qual_dev), and the
// epilogue's, listed in epilogue.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "staging.cuh"
#include "vote_rules.cuh"

namespace {

using gc_staging::clampi;
using gc_staging::cp_async_commit;
using gc_staging::cp_async_wait;
using gc_vote_rules::Bins6;
using gc_vote_rules::kSentinel;
using gc_vote_rules::VoteOut;
using VoteAcc = gc_vote_rules::VoteAcc<Bins6>;

constexpr int kChunk = 8;      // members per shared-memory stage

// Where the refbase rows come from: per job r of the window, the genome
// start gp[r], host row hm[r] (< 0: the genome) and length jp[r]; host
// rows hr [nh, L]; the device genome [G] (G >= L).
struct RefSrc {
  const uint8_t* genome;
  const int32_t* gp;
  const int32_t* hm;
  const int32_t* jp;
  const uint8_t* hr;
  int G, nh;
};

// Refbase row r at position p (vote.refbase_combine): the genome start
// as jax.lax.dynamic_slice takes it (a negative start counts once from
// the end, then clamps to [0, G - L]).
__device__ __forceinline__ int refbase_at(const RefSrc& s, int r, int p,
                                          int L) {
  const int h = s.hm[r];
  if (h >= 0) return s.hr[static_cast<size_t>(clampi(h, 0, s.nh - 1)) * L + p];
  if (p >= s.jp[r]) return 0;
  const int g = s.gp[r];
  return s.genome[static_cast<size_t>(clampi(g < 0 ? g + s.G : g, 0, s.G - L)) + p];
}

// Start copying members [k0, k0 + m) of a job into `buf`, laid out
// [member][seq | qual | score][L]; member k is row clamp(base + k).
__device__ __forceinline__ void stage_members(uint8_t* buf,
                                              const uint8_t* __restrict__ seq,
                                              const uint8_t* __restrict__ qual,
                                              const int8_t* __restrict__ score,
                                              int base, int k0, int m, int N,
                                              int L) {
  gc_staging::stage_rows(
      buf, seq, qual, score,
      [=](int mi) { return clampi(base + k0 + mi, 0, N - 1); }, m, L, 0, L);
}

__global__ void __launch_bounds__(256) vote_window_kernel(
    const uint8_t* __restrict__ seq, const uint8_t* __restrict__ qual,
    const int8_t* __restrict__ score, const RefSrc ref,
    uint8_t* __restrict__ refbase_out, const int32_t* __restrict__ jobs,
    const uint8_t* __restrict__ qtable, uint8_t* __restrict__ flat,
    uint8_t* __restrict__ pseq_out, uint8_t* __restrict__ qual_out,
    int32_t* __restrict__ scratch, int N, int L, int Jw, int Jt, int nb,
    int ol, int hi, int mod, int lo, int bsr, int rnum, int rden) {
  extern __shared__ __align__(16) uint8_t stage[];  // 2 x kChunk x 3 x L
  __shared__ uint8_t rows[4 * 256];                 // epilogue.cuh, stride L
  __shared__ gc_epilogue::Slots slots;

  const int g = blockIdx.x;
  const int p = threadIdx.x;
  const bool live = p < L;

  const int32_t* jr = jobs + g;  // field f of job g at jobs[f * Jt + g]
  const size_t js = static_cast<size_t>(Jt);
  const int base = jr[0], cnt = jr[js], jl = jr[2 * js], ridx = jr[3 * js];
  const int cls = jr[4 * js], K = jr[5 * js];

  // members: chunk 0 goes in flight before anything else is read
  const int nchunks = (cnt + kChunk - 1) / kChunk;
  const int stage_bytes = kChunk * 3 * L;
  if (nchunks > 0) stage_members(stage, seq, qual, score, base, 0, min(cnt, kChunk), N, L);
  cp_async_commit();

  const int rb = live ? refbase_at(ref, clampi(ridx, 0, Jw - 1), p, L) : 0;
  const bool has_ref = rb != 0;
  const size_t trow = static_cast<size_t>(clampi(base, 0, N - 1)) * L;
  const int tseq = live ? seq[trow + p] : 0;
  const int tqual = live ? qual[trow + p] : 0;
  // the window's refbase rows, for the buckets it does not take
  if (live) {
    for (int r = g; r < Jw; r += gridDim.x)
      refbase_out[static_cast<size_t>(r) * L + p] =
          static_cast<uint8_t>(refbase_at(ref, r, p, L));
  }

  VoteAcc acc;
  acc.init();
  int out_base = kSentinel;
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      const int k1 = (c + 1) * kChunk;
      stage_members(stage + ((c + 1) & 1) * stage_bytes, seq, qual, score, base,
                    k1, min(cnt - k1, kChunk), N, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* buf = stage + (c & 1) * stage_bytes;
    const int m = min(cnt - c * kChunk, kChunk);
    if (live) {
      for (int mi = 0; mi < m; ++mi) {
        const int s = buf[(mi * 3 + 0) * L + p];
        const int q = buf[(mi * 3 + 1) * L + p];
        const int sc = static_cast<int8_t>(buf[(mi * 3 + 2) * L + p]);
        if (c == 0 && mi == 0) out_base = s;
        acc.add(s, q, sc, rb, has_ref, hi);
      }
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
  // members cnt..K-1 are absent: seq 255, qual 0, score 0 (idempotent, so once)
  if (cnt < K) acc.add(kSentinel, 0, 0, rb, has_ref, hi);
  const VoteOut vo = gc_vote_rules::vote_decide<Bins6>(
      acc, out_base, rb, has_ref, hi, mod, lo, bsr, rnum, rden);

  // ---- the epilogue (epilogue.cuh)
  int2 d = make_int2(0, 0);
  if (live) d = gc_epilogue::put_position(rows, L, p, p < jl, vo, tseq, tqual);
  int diff = 0, minc = 0;
  gc_epilogue::count_block(d, diff, minc);
  gc_epilogue::rollback(rows, L, ol, minc);
  gc_epilogue::write_dense(rows, L, ol, pseq_out + static_cast<size_t>(g) * (ol >> 1),
                           qual_out + static_cast<size_t>(g) * ol);
  const size_t J = static_cast<size_t>(Jt);
  const int qvw = qtable != nullptr ? gc_epilogue::kRuns / 2 : gc_epilogue::kRuns;
  gc_epilogue::Wire w;
  w.qv = flat;
  w.qs = w.qv + J * qvw;
  w.nr = w.qs + J * gc_epilogue::kRuns;
  w.sp = w.nr + J;
  w.sb = w.sp + J * gc_epilogue::kDiffs;
  w.nd = w.sb + J * (gc_epilogue::kDiffs / 2);
  w.df = w.nd + J;
  w.mc = w.df + 2 * J;
  uint8_t* const bads = w.mc + 2 * J;
  const int nbad = gc_epilogue::encode_sparse(rows, L, ol, qtable, slots, w, g,
                                              diff, minc);

  // ---- per-class escape counts: atomics, then the last block writes them
  if (p != 0) return;
  if (nbad) atomicAdd(&scratch[cls], nbad);
  __threadfence();
  const unsigned ticket = atomicAdd(reinterpret_cast<unsigned*>(&scratch[nb]), 1u);
  if (ticket == gridDim.x - 1) {
    __threadfence();
    for (int c = 0; c < nb; ++c) {
      const unsigned v = static_cast<unsigned>(atomicAdd(&scratch[c], 0));
      uint8_t* d8 = bads + 4 * static_cast<size_t>(c);
      d8[0] = static_cast<uint8_t>(v & 0xFF);
      d8[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
      d8[2] = static_cast<uint8_t>((v >> 16) & 0xFF);
      d8[3] = static_cast<uint8_t>(v >> 24);
    }
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = success).
// seq/qual u8 [N, L], score i8 [N, L] (16-byte aligned, L % 16 == 0,
// L <= 256); the refbase sources: genome u8 [G] (G >= L), per job of the
// window gp, hm, jp i32 [Jw], host rows hr u8 [nh, L] (nh >= 1);
// jobs i32 [6, Jt], one row per field: base row, member count <= K, job
// length, refbase row, class index < nb, class size K; qtable u8 [16] or
// null; outputs: refbase u8 [Jw, L], flat u8 (the wire buffer of all Jt
// jobs and nb classes), pseq u8 [Jt, ol/2], qual_out u8 [Jt, ol];
// scratch i32 [nb + 1] (zeroed here). 2 <= ol <= L, ol even.
extern "C" int gc_vote_window(const void* seq, const void* qual,
                              const void* score, const void* genome,
                              const void* gp, const void* hm, const void* jp,
                              const void* hr, void* refbase, const void* jobs,
                              const void* qtable, void* flat, void* pseq,
                              void* qual_out, void* scratch, int N, int L,
                              int G, int nh, int Jw, int Jt, int nb, int ol,
                              int hi, int mod, int lo, int bsr, int rnum,
                              int rden, void* stream) {
  if (Jt <= 0) return 0;
  if (N <= 0 || L <= 0 || L > 256 || (L & 15) || G < L || nh <= 0 ||
      Jw <= 0 || nb <= 0 || ol < 2 || ol > L || (ol & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (nb + 1), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  RefSrc ref;
  ref.genome = static_cast<const uint8_t*>(genome);
  ref.gp = static_cast<const int32_t*>(gp);
  ref.hm = static_cast<const int32_t*>(hm);
  ref.jp = static_cast<const int32_t*>(jp);
  ref.hr = static_cast<const uint8_t*>(hr);
  ref.G = G;
  ref.nh = nh;
  const int threads = ((L + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(2) * kChunk * 3 * L;
  vote_window_kernel<<<Jt, threads, smem, st>>>(
      static_cast<const uint8_t*>(seq), static_cast<const uint8_t*>(qual),
      static_cast<const int8_t*>(score), ref, static_cast<uint8_t*>(refbase),
      static_cast<const int32_t*>(jobs), static_cast<const uint8_t*>(qtable),
      static_cast<uint8_t*>(flat), static_cast<uint8_t*>(pseq),
      static_cast<uint8_t*>(qual_out), static_cast<int32_t*>(scratch), N, L,
      Jw, Jt, nb, ol, hi, mod, lo, bsr, rnum, rden);
  return static_cast<int>(cudaGetLastError());
}
