// The whole-window consensus vote for Hopper, fused: per job, the vote of
// Group::makeConsensus (group.cpp:369-526) over its members, the per-read
// rollback (group.cpp:538-566), nibble packing and the sparse wire encoding,
// written straight into the window's flat download buffer.
//
// Replaces, on the JAX side, what gencore_tpu/core/pallas_vote.py's
// _pallas_window_all composes for each k-class: the member gather
// seq_dev[rows_t], the Pallas kernel (_pallas_core, _kernel/_vote_block)
// and _epilogue_core(sparse=True, qtable), plus the cross-class wire
// concat. The refbase assembly stays outside (plain torch): the engine
// keeps its rows for the leftover buckets.
//
// Bound. Per (member, position) the kernel must read 3 bytes (seq, qual,
// score) and do ~10 integer operations (bin match, count, score sum, qual
// sum, top qual, total, ref match); per job it writes ~27 sparse bytes
// plus the 1.5 B/position dense fallback. Against the H100's 3.35 TB/s and
// ~16.7 T int32 op/s (132 SMs x 64 lanes x 1.98 GHz), large member counts
// are bound by integer issue, small ones by the bytes. On an H100 SXM
// (chip_smoke.py phases 2b and 5) the kernel reaches 10-17% of that bound:
// what the bound leaves out dominates at a few members per job, namely the
// per-position decision and epilogue (several times the member work at
// 3 members)
// and each block's latency chain (job row, staged members, barriers).
//
// Design, against what vote.cu did on this path:
//   * one block per job, one thread per position (L <= 256), so every
//     per-row reduction of the epilogue is a block reduction and nothing
//     round-trips through device memory: vote.cu wrote four int32 [J, L]
//     arrays (16 B per position) that ~164 plain-torch launches per class
//     read back;
//   * the loop runs to the job's member count, not to the class size K
//     (a 5-member job in class 16 did 11 empty iterations); absent members
//     matter only as the sentinel template of an empty job and through the
//     sentinel ref-match rule, which one extra add() reproduces;
//   * a job's members are the contiguous rows base..base+count-1 (clamped
//     to the matrix as a JAX gather clamps), so the block stages them into
//     shared memory with cp.async, 16 B per thread, in chunks of kChunk
//     members and two buffers: chunk c+1 is in flight while chunk c is
//     voted. vote.cu issued a dependent chain valid -> row -> seq ->
//     qual/score per member with nothing in flight ahead of it;
//   * the epilogue's ranks (the first C=4 edits, the first R=10 qual runs)
//     come from __ballot_sync + __popc with a per-warp prefix in shared
//     memory; diff, minc and the counts from __syncthreads_count; nibble
//     pairs from __shfl_down_sync;
//   * the class's escape count `bad` is an integer atomicAdd (order-free,
//     so deterministic); the last block to finish (a ticket counter)
//     writes the per-class counts into the buffer.
//
// Exact semantics carried over (each is a byte of the wire buffer):
//   * the vote rules of vote_rules.cuh, Bins6 (see vote.cu for the list);
//   * positions at or beyond the job length take the template row
//     (seq_dev/qual_dev at the clamped base row) and never edit; diff and
//     minc sum over all L positions, then minc > 5 rolls the row back;
//   * the output is cut at ol = min(out_len, L); uint8 `<< 4` truncates;
//   * an absent edit slot holds position 0 and base new_seq[0]; an absent
//     run slot holds position 0 and qual[0] (argmax of an all-false row);
//   * in the qual-table lookup the last matching index wins, and `bad`
//     counts only slots below min(nr, R);
//   * nr and nd clamp to 255, diff and minc wrap to int16.

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kDiffs = 4;      // SPARSE_DIFFS (even: bases pack 2 per byte)
constexpr int kRuns = 10;      // SPARSE_RUNS (even: table indices pack 2 per byte)
constexpr int kMaxWarps = 8;   // L <= 256

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

__device__ __forceinline__ void put_i16(uint8_t* p, int v) {
  const unsigned u = static_cast<unsigned short>(static_cast<short>(v));
  p[0] = static_cast<uint8_t>(u & 0xFF);
  p[1] = static_cast<uint8_t>(u >> 8);
}

__global__ void __launch_bounds__(256) vote_window_kernel(
    const uint8_t* __restrict__ seq, const uint8_t* __restrict__ qual,
    const int8_t* __restrict__ score, const uint8_t* __restrict__ refbase,
    const int32_t* __restrict__ jobs, const uint8_t* __restrict__ qtable,
    uint8_t* __restrict__ flat, uint8_t* __restrict__ pseq_out,
    uint8_t* __restrict__ qual_out, int32_t* __restrict__ scratch, int N,
    int L, int Jw, int Jt, int nb, int ol, int hi, int mod, int lo, int bsr,
    int rnum, int rden) {
  extern __shared__ __align__(16) uint8_t stage[];  // 2 x kChunk x 3 x L
  __shared__ uint8_t new_seq[256];
  __shared__ uint8_t new_qual[256];
  __shared__ int edit_pos[kDiffs], edit_base[kDiffs];
  __shared__ int run_pos[kRuns], run_val[kRuns];
  __shared__ int warp_edits[kMaxWarps], warp_runs[kMaxWarps];

  const int g = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarps = blockDim.x >> 5;
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

  const int rb = live ? refbase[static_cast<size_t>(clampi(ridx, 0, Jw - 1)) * L + p] : 0;
  const bool has_ref = rb != 0;
  const size_t trow = static_cast<size_t>(clampi(base, 0, N - 1)) * L;
  const int tseq = live ? seq[trow + p] : 0;
  const int tqual = live ? qual[trow + p] : 0;

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

  // ---- rollback (pallas_vote._epilogue_core)
  const bool pv = live && p < jl;
  const int chg = pv ? vo.changed : 0;
  const int mp = pv ? vo.minc_pos : 0;
  const int cs = pv ? vo.cand_seq : tseq;
  const int cq = pv ? vo.cand_qual : tqual;
  const int diff = __syncthreads_count(chg != 0);
  const int minc_up = __syncthreads_count(mp > 0);
  const int minc = minc_up - __syncthreads_count(mp < 0);
  const bool rollback = minc > 5;
  const int ns = (rollback ? tseq : cs) & 0xFF;
  const int nq = (rollback ? tqual : cq) & 0xFF;
  const bool out = p < ol;
  if (out) {
    new_seq[p] = static_cast<uint8_t>(ns);
    new_qual[p] = static_cast<uint8_t>(nq);
  }

  // dense fallback: nibble-packed seq [ol/2] and qual [ol]
  const int ns_next = __shfl_down_sync(0xffffffffu, ns, 1);
  if (out) {
    qual_out[static_cast<size_t>(g) * ol + p] = static_cast<uint8_t>(nq);
    if ((p & 1) == 0) {
      pseq_out[static_cast<size_t>(g) * (ol >> 1) + (p >> 1)] =
          static_cast<uint8_t>(((ns << 4) & 0xFF) | ns_next);
    }
  }
  __syncthreads();

  // ---- ranks of the seq edits and of the qual-run starts
  const bool edit = out && ns != tseq;
  const bool rstart = out && (p == 0 || new_qual[p - 1] != nq);
  const unsigned em = __ballot_sync(0xffffffffu, edit);
  const unsigned rm = __ballot_sync(0xffffffffu, rstart);
  if (lane == 0) {
    warp_edits[warp] = __popc(em);
    warp_runs[warp] = __popc(rm);
  }
  __syncthreads();
  int epre = 0, rpre = 0, nd = 0, nr = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int e = warp_edits[w], r = warp_runs[w];
    if (w < warp) {
      epre += e;
      rpre += r;
    }
    nd += e;
    nr += r;
  }
  const unsigned below = (1u << lane) - 1u;
  if (edit) {
    const int r = epre + __popc(em & below);
    if (r < kDiffs) {
      edit_pos[r] = p;
      edit_base[r] = ns;
    }
  }
  if (rstart) {
    const int r = rpre + __popc(rm & below);
    if (r < kRuns) {
      run_pos[r] = p;
      run_val[r] = nq;
    }
  }
  __syncthreads();

  // ---- the job's wire fields, written by warp 0
  if (warp != 0) return;
  const size_t J = static_cast<size_t>(Jt);
  const int qvw = qtable != nullptr ? kRuns / 2 : kRuns;
  const size_t o_qs = J * qvw;
  const size_t o_nr = o_qs + J * kRuns;
  const size_t o_sp = o_nr + J;
  const size_t o_sb = o_sp + J * kDiffs;
  const size_t o_nd = o_sb + J * (kDiffs / 2);
  const size_t o_df = o_nd + J;
  const size_t o_mc = o_df + 2 * J;
  const size_t o_bad = o_mc + 2 * J;

  const int r = lane;
  const bool run_slot = r < kRuns;
  const int rpos = (run_slot && r < nr) ? run_pos[r] : 0;
  const int rval = run_slot ? (r < nr ? run_val[r] : new_qual[0]) : 0;
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
  const int epos = (edit_slot && r < nd) ? edit_pos[r] : 0;
  const int ebase = edit_slot ? (r < nd ? edit_base[r] : new_seq[0]) : 0;
  const int ebase_next = __shfl_down_sync(0xffffffffu, ebase, 1);
  if (run_slot) {
    flat[o_qs + g * kRuns + r] = static_cast<uint8_t>(rpos);
    if (qtable != nullptr) {
      if ((r & 1) == 0)
        flat[g * (kRuns / 2) + (r >> 1)] = static_cast<uint8_t>((qenc << 4) | qenc_next);
    } else {
      flat[g * kRuns + r] = static_cast<uint8_t>(rval);
    }
  }
  if (edit_slot) {
    flat[o_sp + g * kDiffs + r] = static_cast<uint8_t>(epos);
    if ((r & 1) == 0)
      flat[o_sb + g * (kDiffs / 2) + (r >> 1)] =
          static_cast<uint8_t>(((ebase << 4) & 0xFF) | ebase_next);
  }
  if (lane != 0) return;
  flat[o_nr + g] = static_cast<uint8_t>(min(nr, 255));
  flat[o_nd + g] = static_cast<uint8_t>(min(nd, 255));
  put_i16(flat + o_df + 2 * static_cast<size_t>(g), diff);
  put_i16(flat + o_mc + 2 * static_cast<size_t>(g), minc);

  // ---- per-class escape counts: atomics, then the last block writes them
  const int nbad = __popc(bad_mask);
  if (nbad) atomicAdd(&scratch[cls], nbad);
  __threadfence();
  const unsigned ticket = atomicAdd(reinterpret_cast<unsigned*>(&scratch[nb]), 1u);
  if (ticket == gridDim.x - 1) {
    __threadfence();
    for (int c = 0; c < nb; ++c) {
      const unsigned v = static_cast<unsigned>(atomicAdd(&scratch[c], 0));
      uint8_t* d = flat + o_bad + 4 * static_cast<size_t>(c);
      d[0] = static_cast<uint8_t>(v & 0xFF);
      d[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
      d[2] = static_cast<uint8_t>((v >> 16) & 0xFF);
      d[3] = static_cast<uint8_t>(v >> 24);
    }
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 = success).
// seq/qual u8 [N, L], score i8 [N, L] (16-byte aligned, L % 16 == 0,
// L <= 256); refbase u8 [Jw, L]; jobs i32 [6, Jt], one row per field:
// base row, member count <= K, job length, refbase row, class index < nb,
// class size K;
// qtable u8 [16] or null; outputs: flat u8 (the wire buffer of all Jt
// jobs and nb classes), pseq u8 [Jt, ol/2], qual_out u8 [Jt, ol];
// scratch i32 [nb + 1] (zeroed here). 2 <= ol <= L, ol even.
extern "C" int gc_vote_window(const void* seq, const void* qual,
                              const void* score, const void* refbase,
                              const void* jobs, const void* qtable, void* flat,
                              void* pseq, void* qual_out, void* scratch, int N,
                              int L, int Jw, int Jt, int nb, int ol, int hi,
                              int mod, int lo, int bsr, int rnum, int rden,
                              void* stream) {
  if (Jt <= 0) return 0;
  if (N <= 0 || L <= 0 || L > 256 || (L & 15) || Jw <= 0 || nb <= 0 ||
      ol < 2 || ol > L || (ol & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (nb + 1), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = ((L + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(2) * kChunk * 3 * L;
  vote_window_kernel<<<Jt, threads, smem, st>>>(
      static_cast<const uint8_t*>(seq), static_cast<const uint8_t*>(qual),
      static_cast<const int8_t*>(score), static_cast<const uint8_t*>(refbase),
      static_cast<const int32_t*>(jobs), static_cast<const uint8_t*>(qtable),
      static_cast<uint8_t*>(flat), static_cast<uint8_t*>(pseq),
      static_cast<uint8_t*>(qual_out), static_cast<int32_t*>(scratch), N, L,
      Jw, Jt, nb, ol, hi, mod, lo, bsr, rnum, rden);
  return static_cast<int>(cudaGetLastError());
}
