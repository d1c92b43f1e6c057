// The per-job epilogue of the consensus vote, one copy shared by the
// kernels that decide a job in one block: vote_window.cu, vote.cu's
// gathered entry (Bins6) and, for the rollback, vote.cu's Bins16 entry.
// Counterpart of gencore_tpu/core/pallas_vote.py:_epilogue_core (:229):
// the per-read rollback (group.cpp:538-566), the dense rows (seq
// nibble-packed, first base in the high nibble, and qual) and the sparse
// wire encoding (the first kDiffs seq edits against the template, the
// first kRuns qual runs, their counts, diff and minc, and the qual-table
// escapes), run by the block that decided the job, so no per-position
// array leaves the kernel.
//
// A job's rows sit in shared memory, 4 x L bytes at stride L:
// [candidate seq | candidate qual | template seq | template qual]. The
// caller fills them position by position (put_position), sums diff and
// minc over the block (count_block / count_warp), then calls rollback and
// write_dense, and encode_sparse for the wire fields. Every function
// after put_position is called by all threads of the block (blockDim a
// multiple of 32, at most 32 * kMaxWarps).
//
// Exact semantics carried over (each is a byte of the output):
//   * positions at or beyond the job length take the template row and
//     never edit; diff and minc sum over all L positions, then minc > 5
//     rolls the row back to the template;
//   * the output is cut at ol = min(out_len, L), even; uint8 `<< 4`
//     truncates;
//   * an absent edit slot holds position 0 and base new_seq[0]; an absent
//     run slot holds position 0 and qual[0] (jnp.argmax of an all-false
//     row);
//   * in the qual-table lookup the last matching index wins, and `bad`
//     counts only run slots below min(nr, kRuns) whose value is non-zero
//     and not in the table;
//   * nr and nd clamp to 255, diff and minc wrap to int16.

#pragma once

#include <stdint.h>

#include "vote_rules.cuh"

namespace gc_epilogue {

constexpr int kDiffs = 4;      // SPARSE_DIFFS (even: bases pack 2 per byte)
constexpr int kRuns = 10;      // SPARSE_RUNS (even: table indices pack 2 per byte)
constexpr int kMaxWarps = 16;  // blocks of up to 512 threads

// Shared memory of encode_sparse.
struct Slots {
  int edit_pos[kDiffs], edit_base[kDiffs];
  int run_pos[kRuns], run_val[kRuns];
  int warp_edits[kMaxWarps], warp_runs[kMaxWarps];
};

// The sparse fields' arrays, each at its job 0: job g writes qv at
// g * (kRuns or kRuns / 2 with a qual table), qs at g * kRuns, sp at
// g * kDiffs, sb at g * kDiffs / 2, nr and nd at g, df and mc (int16,
// little-endian) at 2 * g.
struct Wire {
  uint8_t *qv, *qs, *nr, *sp, *sb, *nd, *df, *mc;
};

// Position p's rows from the vote's decision `o` and the template (ts,
// tq); pv = p lies below the job length. Returns (changed, minc_pos),
// masked by pv, for the job's sums.
__device__ __forceinline__ int2 put_position(uint8_t* rows, int L, int p,
                                             bool pv,
                                             const gc_vote_rules::VoteOut& o,
                                             int ts, int tq) {
  rows[p] = static_cast<uint8_t>(pv ? o.cand_seq : ts);
  rows[L + p] = static_cast<uint8_t>(pv ? o.cand_qual : tq);
  rows[2 * L + p] = static_cast<uint8_t>(ts);
  rows[3 * L + p] = static_cast<uint8_t>(tq);
  return make_int2(pv ? o.changed : 0, pv ? o.minc_pos : 0);
}

// Adds to diff and minc the positions the block holds now (all threads;
// a thread without a position passes zeros).
__device__ __forceinline__ void count_block(int2 d, int& diff, int& minc) {
  diff += __syncthreads_count(d.x != 0);
  minc += __syncthreads_count(d.y > 0) - __syncthreads_count(d.y < 0);
}

// The same for positions held by one warp.
__device__ __forceinline__ void count_warp(int2 d, int& diff, int& minc) {
  diff += __popc(__ballot_sync(0xffffffffu, d.x != 0));
  minc += __popc(__ballot_sync(0xffffffffu, d.y > 0)) -
          __popc(__ballot_sync(0xffffffffu, d.y < 0));
}

// The per-read rollback over positions [0, n): minc > 5 puts the template
// back in the candidate rows, which then hold the final rows.
__device__ __forceinline__ void rollback(uint8_t* rows, int L, int n,
                                         int minc) {
  __syncthreads();
  if (minc > 5) {
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      rows[p] = rows[2 * L + p];
      rows[L + p] = rows[3 * L + p];
    }
  }
  __syncthreads();
}

// The job's dense rows: seq nibble pairs [ol/2] and qual [ol].
__device__ __forceinline__ void write_dense(const uint8_t* rows, int L,
                                            int ol, uint8_t* __restrict__ pseq,
                                            uint8_t* __restrict__ qual) {
  for (int p = threadIdx.x; p < ol; p += blockDim.x) qual[p] = rows[L + p];
  for (int i = threadIdx.x; i < ol / 2; i += blockDim.x)
    pseq[i] = static_cast<uint8_t>((rows[2 * i] << 4) | rows[2 * i + 1]);
}

__device__ __forceinline__ void put_i16(uint8_t* p, int v) {
  const unsigned u = static_cast<unsigned short>(static_cast<short>(v));
  p[0] = static_cast<uint8_t>(u & 0xFF);
  p[1] = static_cast<uint8_t>(u >> 8);
}

// Job g's sparse wire fields from the final rows' positions [0, ol) (ol <=
// 256, so a position fits a byte): ranks of the seq edits and qual-run
// starts by ballot and popc with a per-warp prefix in shared memory, over
// as many tiles of blockDim positions as ol needs. Returns, in thread 0,
// how many of the job's run values escaped the qual table (0 without
// one).
__device__ __forceinline__ int encode_sparse(const uint8_t* rows, int L,
                                             int ol,
                                             const uint8_t* __restrict__ qtable,
                                             Slots& s, const Wire& w,
                                             size_t g, int diff, int minc) {
  const uint8_t* ns = rows;
  const uint8_t* nq = rows + L;
  const uint8_t* ts = rows + 2 * L;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int nd = 0, nr = 0;  // edits and runs of the tiles before this one
  for (int p0 = 0; p0 < ol; p0 += blockDim.x) {
    const int p = p0 + t;
    const bool in = p < ol;
    const bool edit = in && ns[p] != ts[p];
    const bool rstart = in && (p == 0 || nq[p - 1] != nq[p]);
    const unsigned em = __ballot_sync(0xffffffffu, edit);
    const unsigned rm = __ballot_sync(0xffffffffu, rstart);
    if (lane == 0) {
      s.warp_edits[warp] = __popc(em);
      s.warp_runs[warp] = __popc(rm);
    }
    __syncthreads();
    int epre = nd, rpre = nr;
    for (int wi = 0; wi < nwarps; ++wi) {
      const int e = s.warp_edits[wi], r = s.warp_runs[wi];
      if (wi < warp) {
        epre += e;
        rpre += r;
      }
      nd += e;
      nr += r;
    }
    if (edit) {
      const int r = epre + __popc(em & below);
      if (r < kDiffs) {
        s.edit_pos[r] = p;
        s.edit_base[r] = ns[p];
      }
    }
    if (rstart) {
      const int r = rpre + __popc(rm & below);
      if (r < kRuns) {
        s.run_pos[r] = p;
        s.run_val[r] = nq[p];
      }
    }
    __syncthreads();  // the slots are complete; warp counts are rewritten
  }

  // ---- the job's fields, written by warp 0 (lane r holds slot r)
  if (warp != 0) return 0;
  const int r = lane;
  const bool run_slot = r < kRuns;
  const int rpos = (run_slot && r < nr) ? s.run_pos[r] : 0;
  const int rval = run_slot ? (r < nr ? s.run_val[r] : nq[0]) : 0;
  int qenc = 0;
  bool found = false;
  if (qtable != nullptr) {
    for (int i = 1; i < 16; ++i) {
      if (qtable[i] == rval) {  // the last matching index wins
        qenc = i;
        found = true;
      }
    }
  }
  const bool bad = qtable != nullptr && run_slot && r < min(nr, kRuns) &&
                   !found && rval != 0;
  const unsigned bad_mask = __ballot_sync(0xffffffffu, bad);
  const int qenc_next = __shfl_down_sync(0xffffffffu, qenc, 1);
  const bool edit_slot = r < kDiffs;
  const int epos = (edit_slot && r < nd) ? s.edit_pos[r] : 0;
  const int ebase = edit_slot ? (r < nd ? s.edit_base[r] : ns[0]) : 0;
  const int ebase_next = __shfl_down_sync(0xffffffffu, ebase, 1);
  if (run_slot) {
    w.qs[g * kRuns + r] = static_cast<uint8_t>(rpos);
    if (qtable != nullptr) {
      if ((r & 1) == 0)
        w.qv[g * (kRuns / 2) + (r >> 1)] = static_cast<uint8_t>((qenc << 4) | qenc_next);
    } else {
      w.qv[g * kRuns + r] = static_cast<uint8_t>(rval);
    }
  }
  if (edit_slot) {
    w.sp[g * kDiffs + r] = static_cast<uint8_t>(epos);
    if ((r & 1) == 0)
      w.sb[g * (kDiffs / 2) + (r >> 1)] =
          static_cast<uint8_t>(((ebase << 4) & 0xFF) | ebase_next);
  }
  if (lane == 0) {
    w.nr[g] = static_cast<uint8_t>(min(nr, 255));
    w.nd[g] = static_cast<uint8_t>(min(nd, 255));
    put_i16(w.df + 2 * g, diff);
    put_i16(w.mc + 2 * g, minc);
  }
  return __popc(bad_mask);
}

}  // namespace gc_epilogue
