// Consensus vote for Hopper: Group::makeConsensus (group.cpp:369-526) per
// (job, position), over K member rows gathered by index.
//
// Replaces the Pallas kernel of the JAX package,
// gencore_tpu/core/pallas_vote.py:_pallas_core (its _kernel/_vote_block
// body and the sentinel pre-pass), and folds in the member gather that the
// JAX window program materializes as seq_dev[rows_t] before the call.
//
// What bounds it on this card: memory. Each member costs ~3 bytes read per
// position (seq, qual, score) plus a few dozen integer ops, far below the
// H100's ops-per-byte balance. The design therefore only makes the loads
// coalesced and keeps everything else in registers:
//   * one thread per (job, position); blockIdx.y walks jobs, the threads of
//     a block cover consecutive positions of one row, so each member load is
//     one contiguous row segment across the warp;
//   * the row index and the valid flag of member k are the same for the
//     whole block (broadcast loads);
//   * the ~30 bin accumulators (6 bins x count/score/qual-sum/top-qual, plus
//     total score and the ref-match evidence) are registers, unrolled over
//     the six bins; nothing is staged in shared memory.
// The vote rules themselves live in vote_rules.cuh, shared with the fused
// window kernel (vote_window.cu), which serves the main path; this kernel
// serves the gathered and pre-gathered entry points.
//
// Semantics carried over exactly from the Pallas kernel:
//   * an invalid member, k = 0 included, reads as seq = 255 (SENTINEL),
//     qual = 0, score = 0; the template base is member 0 after that
//     substitution, so a padded job yields sentinel outputs as in JAX;
//   * a stored seq of 255 also zeroes that member's qual and score;
//   * the score is signed int8;
//   * the elections scan bins in the order (0, 1, 2, 4, 8, 15) with
//     `>` on the score and `>=` on the qual sum (later bins win ties), then
//     the virtual empty bin 14 (13 or 14 for the second election);
//   * the ratio test is top_score*rden < rnum*total_score in wrapping int32;
//   * row indices are clamped to [0, N-1], as JAX clamps a gather.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_rules.cuh"

namespace {

using gc_vote_rules::kSentinel;
using gc_vote_rules::VoteAcc;
using gc_vote_rules::VoteOut;

__global__ void vote_kernel(const uint8_t* __restrict__ seq,
                            const uint8_t* __restrict__ qual,
                            const int8_t* __restrict__ score,
                            const int32_t* __restrict__ rows,
                            const uint8_t* __restrict__ valid,
                            const uint8_t* __restrict__ refbase,
                            int32_t* __restrict__ cand_seq,
                            int32_t* __restrict__ cand_qual,
                            int32_t* __restrict__ changed_out,
                            int32_t* __restrict__ minc_out,
                            int K, int J, int L, int N,
                            int hi, int mod, int lo, int bsr,
                            int rnum, int rden) {
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= L) return;
  for (int j = blockIdx.y; j < J; j += gridDim.y) {
    const size_t out_at = static_cast<size_t>(j) * L + pos;
    const int rb = refbase[out_at];
    const bool has_ref = rb != 0;
    VoteAcc acc;
    acc.init();
    int out_base = kSentinel;

    for (int k = 0; k < K; ++k) {
      const size_t kj = static_cast<size_t>(k) * J + j;
      int s = kSentinel;
      int q = 0;
      int sc = 0;
      if (valid[kj]) {
        int r = rows[kj];
        r = r < 0 ? 0 : (r >= N ? N - 1 : r);
        const size_t at = static_cast<size_t>(r) * L + pos;
        s = seq[at];
        if (s != kSentinel) {
          q = qual[at];
          sc = score[at];
        }
      }
      if (k == 0) out_base = s;
      acc.add(s, q, sc, rb, has_ref, hi);
    }

    const VoteOut o = gc_vote_rules::vote_decide(acc, out_base, rb, has_ref,
                                                 hi, mod, lo, bsr, rnum, rden);
    cand_seq[out_at] = o.cand_seq;
    cand_qual[out_at] = o.cand_qual;
    changed_out[out_at] = o.changed;
    minc_out[out_at] = o.minc_pos;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// seq/qual u8 [N, L], score i8 [N, L], rows i32 [K, J], valid u8 [K, J],
// refbase u8 [J, L]; outputs i32 [J, L]. All arrays contiguous.
extern "C" int gc_vote(const void* seq, const void* qual, const void* score,
                       const void* rows, const void* valid,
                       const void* refbase, void* cand_seq, void* cand_qual,
                       void* changed, void* minc, int K, int J, int L, int N,
                       int hi, int mod, int lo, int bsr, int rnum, int rden,
                       void* stream) {
  if (J <= 0 || L <= 0) return 0;
  int threads = ((L + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 block(threads);
  const dim3 grid((L + threads - 1) / threads, J < 65535 ? J : 65535);
  vote_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), static_cast<const uint8_t*>(qual),
      static_cast<const int8_t*>(score), static_cast<const int32_t*>(rows),
      static_cast<const uint8_t*>(valid), static_cast<const uint8_t*>(refbase),
      static_cast<int32_t*>(cand_seq), static_cast<int32_t*>(cand_qual),
      static_cast<int32_t*>(changed), static_cast<int32_t*>(minc),
      K, J, L, N, hi, mod, lo, bsr, rnum, rden);
  return static_cast<int>(cudaGetLastError());
}
