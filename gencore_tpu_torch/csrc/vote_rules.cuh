// The per-(job, position) rules of the consensus vote, Group::makeConsensus
// (group.cpp:369-526), shared by the two vote kernels (vote.cu and
// vote_window.cu), templated on the bin set:
//
//   * Bins6 — the Pallas kernel's _vote_block
//     (gencore_tpu/core/pallas_vote.py:48), line for line: the non-empty
//     nt16 bins of =ACGTN data (0, 1, 2, 4, 8, 15), the always-empty bins
//     as one virtual bin 14 (13 for the second election), and a stored
//     sentinel base (255) counting with qual = score = 0. Both kernels;
//     the semantics it carries over are listed in vote.cu.
//   * Bins16 — the XLA vote of gencore_tpu/core/kernels.py:_vote_core with
//     full_bins=True (K9): all 16 nt16 bins, no virtual bin, and a stored
//     255 in no bin while its score still counts in the total. vote.cu
//     only; the callers mask members and positions as K9 does.

#pragma once

#include <stdint.h>

namespace gc_vote_rules {

constexpr int kSentinel = 255;
constexpr int kNegInf = -0x7FFFFFFF;

struct Bins6 {
  static constexpr int kBins = 6;
  static constexpr bool kVirtual = true;        // virtual empty bins 13/14
  static constexpr bool kSentinelZeroes = true;  // seq 255 => q = sc = 0
  // BINS = (0, 1, 2, 4, 8, 15): the non-empty nt16 bins of =ACGTN data
  __device__ __forceinline__ static int code(int bi) {
    return bi == 0 ? 0 : (bi == 5 ? 15 : (1 << (bi - 1)));
  }
};

struct Bins16 {
  static constexpr int kBins = 16;
  static constexpr bool kVirtual = false;
  static constexpr bool kSentinelZeroes = false;
  __device__ __forceinline__ static int code(int bi) { return bi; }
};

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// The evidence of one position, kept in registers (the loops over the
// bins unroll). Every field is a wrapping int32 sum, a max or an or, so
// partial accumulators over any split of the members merge exactly.
template <class B>
struct VoteAcc {
  static constexpr int kFields = 4 * B::kBins + 3;
  int cnt[B::kBins], ssum[B::kBins], qsum[B::kBins], topq[B::kBins];
  int total, ref_qual, high_ref;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int bi = 0; bi < B::kBins; ++bi) {
      cnt[bi] = 0;
      ssum[bi] = 0;
      qsum[bi] = 0;
      topq[bi] = 0;
    }
    total = 0;
    ref_qual = 0;
    high_ref = 0;
  }

  // One member's base s, qual q and signed score sc at this position.
  // Bins6: a sentinel base (absent member, or 255 stored) counts with
  // q = sc = 0.
  __device__ __forceinline__ void add(int s, int q, int sc, int rb,
                                      bool has_ref, int hi) {
    if (B::kSentinelZeroes && s == kSentinel) {
      q = 0;
      sc = 0;
    }
    total += sc;
#pragma unroll
    for (int bi = 0; bi < B::kBins; ++bi) {
      if (s == B::code(bi)) {
        cnt[bi] += 1;
        ssum[bi] += sc;
        qsum[bi] += q;
        topq[bi] = max(topq[bi], q);
      }
    }
    if (has_ref && s == rb) {
      ref_qual = max(ref_qual, q);
      high_ref |= q >= hi;
    }
  }

  // Field f of thread t at x[f * stride + t] (conflict-free in shared
  // memory).
  __device__ __forceinline__ void store(int* x, int stride) const {
#pragma unroll
    for (int bi = 0; bi < B::kBins; ++bi) {
      x[(0 * B::kBins + bi) * stride] = cnt[bi];
      x[(1 * B::kBins + bi) * stride] = ssum[bi];
      x[(2 * B::kBins + bi) * stride] = qsum[bi];
      x[(3 * B::kBins + bi) * stride] = topq[bi];
    }
    x[(4 * B::kBins + 0) * stride] = total;
    x[(4 * B::kBins + 1) * stride] = ref_qual;
    x[(4 * B::kBins + 2) * stride] = high_ref;
  }

  __device__ __forceinline__ void merge(const int* x, int stride) {
#pragma unroll
    for (int bi = 0; bi < B::kBins; ++bi) {
      cnt[bi] += x[(0 * B::kBins + bi) * stride];
      ssum[bi] += x[(1 * B::kBins + bi) * stride];
      qsum[bi] += x[(2 * B::kBins + bi) * stride];
      topq[bi] = max(topq[bi], x[(3 * B::kBins + bi) * stride]);
    }
    total += x[(4 * B::kBins + 0) * stride];
    ref_qual = max(ref_qual, x[(4 * B::kBins + 1) * stride]);
    high_ref |= x[(4 * B::kBins + 2) * stride];
  }
};

struct VoteOut {
  int cand_seq, cand_qual, changed, minc_pos;
};

// Elections, early accept, needToCheckRef and ref arbitration over the
// evidence; out_base is member 0's base (the template).
template <class B>
__device__ __forceinline__ VoteOut vote_decide(const VoteAcc<B>& a,
                                               int out_base, int rb,
                                               bool has_ref, int hi, int mod,
                                               int lo, int bsr, int rnum,
                                               int rden) {
  // top election: lexmax of (score, qual sum, bin)
  int top_base = 0, top_score = kNegInf, top_qs = 0;
#pragma unroll
  for (int bi = 0; bi < B::kBins; ++bi) {
    if (a.ssum[bi] > top_score || (a.ssum[bi] == top_score && a.qsum[bi] >= top_qs)) {
      top_base = B::code(bi);
      top_score = a.ssum[bi];
      top_qs = a.qsum[bi];
    }
  }
  if (B::kVirtual &&
      (0 > top_score || (top_score == 0 && top_qs <= 0 && top_base < 14))) {
    top_base = 14;
    top_score = 0;
    top_qs = 0;
  }
  // second election, skipping the top bin
  int sec_base = 0, sec_score = kNegInf, sec_qs = 0;
#pragma unroll
  for (int bi = 0; bi < B::kBins; ++bi) {
    if (top_base != B::code(bi) &&
        (a.ssum[bi] > sec_score || (a.ssum[bi] == sec_score && a.qsum[bi] >= sec_qs))) {
      sec_base = B::code(bi);
      sec_score = a.ssum[bi];
      sec_qs = a.qsum[bi];
    }
  }
  if (B::kVirtual) {
    const int vidx = top_base == 14 ? 13 : 14;
    if (0 > sec_score || (sec_score == 0 && sec_qs <= 0 && sec_base < vidx)) {
      sec_base = vidx;
      sec_score = 0;
      sec_qs = 0;
    }
  }

  // per-bin lookups; the virtual bins read as empty
  int top_num = 0, top_qual = 0, sec_num = 0, sec_qsum = 0;
#pragma unroll
  for (int bi = 0; bi < B::kBins; ++bi) {
    if (top_base == B::code(bi)) {
      top_num = a.cnt[bi];
      top_qual = a.topq[bi];
    }
    if (sec_base == B::code(bi)) {
      sec_num = a.cnt[bi];
      sec_qsum = a.qsum[bi];
    }
  }

  const bool accept_early = sec_num == 0 && top_score >= bsr && top_qual >= mod;
  bool need_ref = sec_num == 0 && !accept_early;
  if (sec_num == 1) {
    need_ref |= sec_qsum <= lo ? (top_num < 2 && top_qual < hi)
                               : (top_num < 3 || top_qual < hi);
  }
  if (sec_num > 1) {
    need_ref |= wrap_mul(top_score, rden) < wrap_mul(rnum, a.total) || top_qual < mod;
  }
  need_ref |= top_score < bsr || top_qual <= lo;
  const bool do_ref = need_ref && has_ref && !accept_early;

  int top_base2 = (do_ref && a.high_ref) ? rb : top_base;
  top_base2 = (do_ref && top_qual < mod) ? rb : top_base2;
  const int top_qual2 = (do_ref && top_base2 == rb) ? a.ref_qual : top_qual;

  const bool changed = !accept_early && out_base != top_base2;
  const int inner = out_base == rb ? 1 : (top_base2 == rb ? -1 : 0);
  VoteOut o;
  o.cand_seq = changed ? top_base2 : out_base;
  o.cand_qual = accept_early ? top_qual : top_qual2;
  o.changed = changed ? 1 : 0;
  o.minc_pos = (changed && has_ref) ? inner : 0;
  return o;
}

}  // namespace gc_vote_rules
