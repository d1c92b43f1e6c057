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
// plus the 1.5 B/position dense fallback. Against the H100's 3.35 TB/s and ~16.7 T int32 op/s (132
// SMs x 64 lanes x 1.98 GHz), large member counts are bound by integer
// issue, small ones by the bytes.
//
// What bounds it in fact. The deep panel's windows hold ~16k jobs of ~3
// members (k-classes 4 and 16), so the member work that the bound counts
// is small beside each job's fixed work. The first design (one block of L
// threads per job) took 0.130 ms at the largest window, 7.5%
// of its bound; a clock64() split of its blocks (PERF.md §6) gave 37%
// of a block's time to a chain of dependent loads (job row -> refbase
// sources -> genome; the template row) and to the refbase rows it built a
// second time, 37% to the epilogue's seven barriers and each block's
// fence and ticket, 15% to the decision and 11% to the members.
//
// Design:
//   * persistent blocks, as many as are resident at once (at most 64
//     registers: 6 blocks of 160 threads per SM), one thread per position
//     (L <= 256); a block takes its first three jobs by stride and the
//     rest from a counter, since the jobs are ordered class by class and
//     the deep classes come last; the class's escape count (an order-free
//     integer atomicAdd per job) and the last block's write of the counts
//     (a ticket, taken once the block's last count is fenced) stay exact;
//   * a job pipeline in shared memory: while job n is decided, job n+1's
//     member rows (its first kStage members, the first of them the
//     template, staged for an empty job too, by cp.async stepping by
//     pointer: a bulk copy (TMA) per matrix was at most 0.4% faster at
//     any shape and 0.9% slower at the deep panel's window) and refbase
//     row (the host row, or the 16-byte chunks of the genome that hold
//     its slice), job n+2's refbase sources (gp, hm, jp) and job n+3's
//     table fields are in flight, so each level of the chain is
//     requested one job ahead of its use and one barrier per job waits
//     for all of it; a job of more than kStage members votes the rest in
//     chunks through one more buffer;
//   * the refbase rows are read, not written: a job's row lives only in
//     the shared memory it votes from (the gathered vote, vote.cu, reads
//     the rows of the window's other jobs from the same sources);
//   * the loop runs to the job's member count, not to the class size K;
//     absent members matter only as the sentinel template of an empty job
//     and through the sentinel ref-match rule, which one extra add()
//     reproduces;
//   * a shorter per-job tail than epilogue.cuh's (which vote.cu keeps):
//     each thread keeps its position's candidate and template in
//     registers, so the rollback is a select once the job's minc is
//     known; one barrier sums diff and minc and, for both outcomes of the
//     rollback, the warps' edit and run-start counts (run starts across a
//     warp boundary are settled after it); the next job's first barrier
//     completes the wire slots, whose fields one warp writes while the
//     others vote that job. The qual table's inverse (value -> last
//     matching index) is built once per block.
//
// Time (tools/kernel_ab.py --window, in turns with the first design, on
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): 0.0937 ms at the deep
// panel's largest window (16,064 jobs; chip_smoke.py phase 5's replay),
// 10.4% of its 0.00975 ms bound (bytes), against the first design's
// 0.1306 ms (7.5%); 0.0326 / 0.0432 ms at phase 2b's K = 4 / 16 (J =
// 4096) against 0.0335 / 0.0438 ms.
//
// Exact semantics carried over (each is a byte of the wire buffer): the
// vote rules of vote_rules.cuh, Bins6 (see vote.cu for the list), with the
// template row at the job's clamped base row (seq_dev/qual_dev), and the
// epilogue's, listed in epilogue.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "epilogue.cuh"
#include "refbase.cuh"
#include "staging.cuh"
#include "vote_rules.cuh"

namespace {

using gc_epilogue::kDiffs;
using gc_epilogue::kRuns;
using gc_refsrc::genome_start;
using gc_refsrc::RefSrc;
using gc_staging::clampi;
using gc_staging::cp_async16;
using gc_staging::cp_async_commit;
using gc_staging::cp_async_wait;
using gc_vote_rules::Bins6;
using gc_vote_rules::kSentinel;
using gc_vote_rules::VoteOut;
using VoteAcc = gc_vote_rules::VoteAcc<Bins6>;

constexpr int kStage = 16;     // members per shared-memory stage
constexpr int kMaxWarps = 8;   // L <= 256
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

// The block's shared state besides the staged rows: rings of the next
// jobs' table fields and refbase sources, per-warp sums, the wire slots
// and the qual table's inverse.
struct Shared {
  int fields[4][6];   // base, count, job length, refbase row, class, K
  int src[3][3];      // gp, hm, jp of the job's (clamped) refbase row
  unsigned wsum[kMaxWarps][3];
  int edit_pos[kDiffs], edit_base[kDiffs];
  int run_pos[kRuns], run_val[kRuns];
  int jobidx[4];      // the block's next jobs
  // the last job's index, class, runs, edits, diff, minc, final seq and
  // qual at position 0: its wire fields are written during the next job
  int last[8];
  uint8_t qinv[256];  // qual value -> last index of the table holding it
};

struct Args {
  const uint8_t* seq;
  const uint8_t* qual;
  const int8_t* score;
  RefSrc ref;
  const int32_t* jobs;   // field f of job g at jobs[f * Jt + g]
  const uint8_t* qtable;
  uint8_t* flat;
  uint8_t* pseq_out;
  uint8_t* qual_out;
  int32_t* scratch;
  int N, L, Jw, Jt, nb, ol, hi, mod, lo, bsr, rnum, rden;
};

// 4 blocks of 256 threads per SM at least: at most 64 registers, so that
// 6 blocks of 160 threads (L = 160) are resident at once
__global__ void __launch_bounds__(256, 4) vote_window_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ Shared sh;

  const int L = a.L;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool live = t < L;
  const int grid = gridDim.x;
  const size_t Jt = static_cast<size_t>(a.Jt);
  // two ring slots [members kStage x 3 x L | refbase bytes L + 16], then
  // the overflow chunk buffer of a deep job
  const int mem_bytes = kStage * 3 * L;
  const int slot_bytes = mem_bytes + L + 16;
  uint8_t* const ov = dyn + 2 * slot_bytes;
  // the warps that, besides their positions, issue the next jobs' copies
  // and write the last job's wire fields (one warp for all the copies
  // measured 1-3% faster than three)
  const int issue_warp = nwarps - 1;
  const int wire_warp = nwarps > 1 ? 1 : 0;

  // member rows are staged [seq | qual | score][kStage][L]; the thread's
  // 16 bytes of a row copy: array `arr` at byte `off`, of members mstart,
  // mstart + per_pass, ...
  const int vpr = L >> 4;
  const int per_member = 3 * vpr;
  const int per_pass = blockDim.x / per_member;
  const int mfirst = t / per_member;
  const int arr = (t - mfirst * per_member) / vpr;
  const int off = (t - mfirst * per_member - arr * vpr) << 4;
  const int mstart = mfirst < per_pass ? mfirst : kStage;  // past the last pass: none
  const uint8_t* const src_arr =
      arr == 0 ? a.seq : (arr == 1 ? a.qual : reinterpret_cast<const uint8_t*>(a.score));
  // start copying members [k0, k0 + m) of the job at row `base` into buf;
  // member k is row clamp(base + k). Rows inside the matrix (all but a
  // job's at its end) step by pointer.
  const int first = (arr * kStage + mstart) * L + off;
  const int step = per_pass * L;
  auto stage = [&](uint8_t* buf, int base, int k0, int m) {
    const int r0 = base + k0;
    if (r0 >= 0 && r0 + m <= a.N) {
      uint8_t* dst = buf + first;
      const uint8_t* src = src_arr + static_cast<size_t>(r0 + mstart) * L + off;
      for (int mi = mstart; mi < m; mi += per_pass, dst += step, src += step)
        cp_async16(dst, src);
    } else {
      for (int mi = mstart; mi < m; mi += per_pass)
        cp_async16(buf + (arr * kStage + mi) * L + off,
                   src_arr + static_cast<size_t>(clampi(r0 + mi, 0, a.N - 1)) * L + off);
    }
  };
  // the block's first jobs are blockIdx.x + k grid (k < 3), the rest come
  // from a counter: the jobs are ordered class by class, so a static
  // stride would leave the deep classes' imbalance to the last jobs
  auto job = [&](int n) { return sh.jobidx[n & 3]; };
  // job n's table fields: lanes 0-5 of the issuing warp
  auto issue_fields = [&](int n) {
    const int g = job(n);
    if (warp == issue_warp && lane < 6 && g < a.Jt)
      cp_async4(&sh.fields[n & 3][lane], a.jobs + lane * Jt + g);
  };
  // job n's refbase sources, of its refbase row r: lanes 8-10
  auto issue_sources = [&](int n, int r) {
    if (warp == issue_warp && lane >= 8 && lane < 11 && job(n) < a.Jt) {
      const int i = lane - 8;
      const int32_t* s = i == 0 ? a.ref.gp : (i == 1 ? a.ref.hm : a.ref.jp);
      cp_async4(&sh.src[n % 3][i], s + clampi(r, 0, a.Jw - 1));
    }
  };
  // job n's member rows (all threads, cp.async) and refbase row (lanes
  // 12-28 of the issuing warp): the host row, or the 16-byte chunks of the
  // genome that hold its slice (the allocation is 16-byte aligned, so they
  // lie inside it).
  auto issue_rows = [&](int n, int base, int cnt, int gp, int hm) {
    if (job(n) >= a.Jt) return;
    uint8_t* slot = dyn + (n & 1) * slot_bytes;
    stage(slot, base, 0, max(1, min(cnt, kStage)));
    if (warp == issue_warp && lane >= 12 && lane < 29) {
      const int c = lane - 12;
      const uint8_t* from;
      int chunks;
      if (hm >= 0) {
        from = a.ref.hr + static_cast<size_t>(clampi(hm, 0, a.ref.nh - 1)) * L;
        chunks = vpr;
      } else {
        const uint8_t* at = a.ref.genome + genome_start(gp, a.ref.G, L);
        from = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(at) &
                                                ~static_cast<uintptr_t>(15));
        chunks = static_cast<int>((at + L - from + 15) >> 4);
      }
      if (c < chunks) cp_async16(slot + mem_bytes + 16 * c, from + 16 * c);
    }
  };

  // ---- the pipeline's first jobs, then what the block does once
  int* const next_job = a.scratch + a.nb + 1;
  int pending = 0;  // the block's job 3, and in the loop job n + 4
  if (t == 0) {
    for (int k = 0; k < 3; ++k) sh.jobidx[k] = static_cast<int>(blockIdx.x) + k * grid;
    pending = 3 * grid + atomicAdd(next_job, 1);
  }
  __syncthreads();
  issue_fields(0);
  issue_fields(1);
  issue_fields(2);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  issue_sources(0, sh.fields[0][3]);
  issue_sources(1, sh.fields[1][3]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  issue_rows(0, sh.fields[0][0], sh.fields[0][1], sh.src[0][0], sh.src[0][1]);
  cp_async_commit();
  if (a.qtable != nullptr) {
    for (int v = t; v < 256; v += blockDim.x) {
      int idx = 0;
      for (int i = 1; i < 16; ++i)
        if (a.qtable[i] == v) idx = i;  // the last matching index wins
      sh.qinv[v] = static_cast<uint8_t>(idx);
    }
  }

  if (t == 0) sh.jobidx[3] = pending;

  const int qvw = a.qtable != nullptr ? kRuns / 2 : kRuns;
  gc_epilogue::Wire w;
  w.qv = a.flat;
  w.qs = w.qv + Jt * qvw;
  w.nr = w.qs + Jt * kRuns;
  w.sp = w.nr + Jt;
  w.sb = w.sp + Jt * kDiffs;
  w.nd = w.sb + Jt * (kDiffs / 2);
  w.df = w.nd + Jt;
  w.mc = w.df + 2 * Jt;
  uint8_t* const bads = w.mc + 2 * Jt;
  const unsigned below = (1u << lane) - 1u;

  for (int n = 0;; ++n) {
    const int g = job(n);
    cp_async_wait<0>();
    __syncthreads();  // job n's rows, n+1's sources, n+2's fields are in;
                      // job n-1's wire slots are complete

    // ---- job n-1's wire fields (lane r holds slot r), while the other
    // warps go on
    if (warp == wire_warp && n > 0) {
      const int* const last = sh.last;
      const int lg = last[0], lcls = last[1], nr = last[2], nd = last[3];
      const int r = lane;
      const bool run_slot = r < kRuns;
      const int rpos = (run_slot && r < nr) ? sh.run_pos[r] : 0;
      const int rval = run_slot ? (r < nr ? sh.run_val[r] : last[7]) : 0;
      const int qenc = a.qtable != nullptr ? sh.qinv[rval & 0xFF] : 0;
      const bool bad = a.qtable != nullptr && run_slot && r < min(nr, kRuns) &&
                       qenc == 0 && rval != 0;
      const unsigned bad_mask = __ballot_sync(kAll, bad);
      const int qenc_next = __shfl_down_sync(kAll, qenc, 1);
      const bool edit_slot = r < kDiffs;
      const int epos = (edit_slot && r < nd) ? sh.edit_pos[r] : 0;
      const int ebase = edit_slot ? (r < nd ? sh.edit_base[r] : last[6]) : 0;
      const int ebase_next = __shfl_down_sync(kAll, ebase, 1);
      const size_t gj = static_cast<size_t>(lg);
      if (run_slot) {
        w.qs[gj * kRuns + r] = static_cast<uint8_t>(rpos);
        if (a.qtable != nullptr) {
          if ((r & 1) == 0)
            w.qv[gj * (kRuns / 2) + (r >> 1)] = static_cast<uint8_t>((qenc << 4) | qenc_next);
        } else {
          w.qv[gj * kRuns + r] = static_cast<uint8_t>(rval);
        }
      }
      if (edit_slot) {
        w.sp[gj * kDiffs + r] = static_cast<uint8_t>(epos);
        if ((r & 1) == 0)
          w.sb[gj * (kDiffs / 2) + (r >> 1)] =
              static_cast<uint8_t>(((ebase << 4) & 0xFF) | ebase_next);
      }
      if (lane == 0) {
        w.nr[gj] = static_cast<uint8_t>(min(nr, 255));
        w.nd[gj] = static_cast<uint8_t>(min(nd, 255));
        gc_epilogue::put_i16(w.df + 2 * gj, last[4]);
        gc_epilogue::put_i16(w.mc + 2 * gj, last[5]);
        // the class's escape count: an integer atomic, order-free
        if (bad_mask) atomicAdd(&a.scratch[lcls], __popc(bad_mask));
      }
    }
    if (g >= a.Jt) break;

    // this job's fields and sources, and what the next jobs' copies need
    const int* f = sh.fields[n & 3];
    const int base = f[0], cnt = f[1], jl = f[2], cls = f[4];
    const int K = f[5];
    const int* s = sh.src[n % 3];
    const int gp = s[0], hm = s[1], jp = s[2];
    const int base1 = sh.fields[(n + 1) & 3][0], cnt1 = sh.fields[(n + 1) & 3][1];
    const int gp1 = sh.src[(n + 1) % 3][0], hm1 = sh.src[(n + 1) % 3][1];
    const int ridx2 = sh.fields[(n + 2) & 3][3];
    if (t == 0) pending = 3 * grid + atomicAdd(next_job, 1);
    issue_fields(n + 3);
    issue_sources(n + 2, ridx2);
    issue_rows(n + 1, base1, cnt1, gp1, hm1);
    cp_async_commit();

    const uint8_t* slot = dyn + (n & 1) * slot_bytes;
    const int goff = hm >= 0 ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(
                                       a.ref.genome + genome_start(gp, a.ref.G, L)) & 15);
    int rb = 0, tseq = 0, tqual = 0;
    if (live) {
      rb = (hm < 0 && t >= jp) ? 0 : slot[mem_bytes + goff + t];
      tseq = slot[t];
      tqual = slot[kStage * L + t];
    }
    const bool has_ref = rb != 0;

    // ---- the vote: chunk 0 from the ring slot, the rest through ov
    VoteAcc acc;
    acc.init();
    const int nchunks = (cnt + kStage - 1) / kStage;
    for (int c = 0; c < nchunks; ++c) {
      if (c > 0) {
        stage(ov, base, c * kStage, min(cnt - c * kStage, kStage));
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const uint8_t* buf = c == 0 ? slot : ov;
      const int m = min(cnt - c * kStage, kStage);
      if (live) {
        for (int mi = 0; mi < m; ++mi) {
          acc.add(buf[mi * L + t], buf[(kStage + mi) * L + t],
                  static_cast<int8_t>(buf[(2 * kStage + mi) * L + t]), rb, has_ref,
                  a.hi);
        }
      }
      if (c > 0) __syncthreads();  // ov is refilled next
    }
    // members cnt..K-1 are absent: seq 255, qual 0, score 0 (idempotent, so once)
    if (cnt < K) acc.add(kSentinel, 0, 0, rb, has_ref, a.hi);
    const int out_base = cnt > 0 ? tseq : kSentinel;
    const VoteOut vo = gc_vote_rules::vote_decide<Bins6>(
        acc, out_base, rb, has_ref, a.hi, a.mod, a.lo, a.bsr, a.rnum, a.rden);

    // ---- the tail. Without rollback a position below the job length
    // takes the candidate (cs, cq), else the template; with rollback
    // (minc > 5) every position takes the template, so no edit.
    const bool pv = live && t < jl;
    const int cs = pv ? vo.cand_seq : tseq;
    const int cq = pv ? vo.cand_qual : tqual;
    const bool in = t < a.ol;
    const int cq_up = __shfl_up_sync(kAll, cq, 1);
    const int tq_up = __shfl_up_sync(kAll, tqual, 1);
    // run starts within the warp; lane 0 of a later warp is settled below
    const bool lead = lane == 0;
    const unsigned m_chg = __ballot_sync(kAll, pv && vo.changed);
    const unsigned m_pos = __ballot_sync(kAll, pv && vo.minc_pos > 0);
    const unsigned m_neg = __ballot_sync(kAll, pv && vo.minc_pos < 0);
    const unsigned m_edit = __ballot_sync(kAll, in && cs != tseq);
    const unsigned m_run = __ballot_sync(kAll, in && (lead ? t == 0 : cq_up != cq));
    const unsigned m_run_t = __ballot_sync(kAll, in && (lead ? t == 0 : tq_up != tqual));
    const int cq_last = __shfl_sync(kAll, cq, 31);
    const int tq_last = __shfl_sync(kAll, tqual, 31);
    if (lead) {
      // 10-bit fields: their sums over the warps stay below 1024
      sh.wsum[warp][0] = __popc(m_chg) | __popc(m_pos) << 10 | __popc(m_neg) << 20;
      sh.wsum[warp][1] = __popc(m_edit) | __popc(m_run) << 10 | __popc(m_run_t) << 20;
      sh.wsum[warp][2] = static_cast<unsigned>(cq) | static_cast<unsigned>(tqual) << 8 |
                         static_cast<unsigned>(cq_last) << 16 |
                         static_cast<unsigned>(tq_last) << 24;
    }
    __syncthreads();
    // every warp sums the warps' counts, lane i holding warp i's
    unsigned x0 = 0, x1 = 0, x2 = 0, xp = 0;
    if (lane < nwarps) {
      x0 = sh.wsum[lane][0];
      x1 = sh.wsum[lane][1];
      x2 = sh.wsum[lane][2];
      if (lane > 0) xp = sh.wsum[lane - 1][2];
    }
    const unsigned sums = __reduce_add_sync(kAll, x0);
    // the run start at warp `lane`'s first position, across the boundary,
    // without (bit 0) and with (bit 1) the rollback
    const bool bound = lane > 0 && lane < nwarps && 32 * lane < a.ol;
    const unsigned leads =
        (bound && ((xp >> 16) & 0xFF) != (x2 & 0xFF) ? 1u : 0u) |
        (bound && (xp >> 24) != ((x2 >> 8) & 0xFF) ? 2u : 0u);
    // edits, run starts without and with the rollback of warp `lane`, in
    // 10-bit fields, scanned over the warps alongside the sums
    const unsigned er = x1 + ((leads & 1u) << 10) + ((leads >> 1) << 20);
    unsigned scan = er;
#pragma unroll
    for (int o = 1; o < kMaxWarps; o <<= 1) {
      const unsigned u = __shfl_up_sync(kAll, scan, o);
      if (lane >= o) scan += u;
    }
    const unsigned total = __shfl_sync(kAll, scan, kMaxWarps - 1);
    const unsigned pre = __shfl_sync(kAll, scan - er, warp);
    const unsigned my_leads = __shfl_sync(kAll, leads, warp);
    const int diff = static_cast<int>(sums & 1023);
    const int minc = static_cast<int>((sums >> 10) & 1023) - static_cast<int>(sums >> 20);
    const bool roll = minc > 5;
    const int nd = roll ? 0 : static_cast<int>(total & 1023);
    const int nr = static_cast<int>(roll ? total >> 20 : (total >> 10) & 1023);
    const int epre = static_cast<int>(pre & 1023);
    const int rpre = static_cast<int>(roll ? pre >> 20 : (pre >> 10) & 1023);
    const bool my_lead_run = ((roll ? my_leads >> 1 : my_leads) & 1u) != 0;

    const int fs = roll ? tseq : cs;
    const int fq = roll ? tqual : cq;
    if (!roll && in && cs != tseq) {
      const int r = epre + __popc(m_edit & below);
      if (r < kDiffs) {
        sh.edit_pos[r] = t;
        sh.edit_base[r] = fs;
      }
    }
    const unsigned m_any = roll ? m_run_t : m_run;
    const unsigned m_r = (m_any & ~1u) | (warp > 0 ? (my_lead_run ? 1u : 0u) : (m_any & 1u));
    if ((m_r >> lane) & 1u) {
      const int r = rpre + __popc(m_r & below);
      if (r < kRuns) {
        sh.run_pos[r] = t;
        sh.run_val[r] = fq;
      }
    }
    // the dense rows: qual, and seq nibble pairs (uint8 << 4 truncates)
    const int fs_next = __shfl_down_sync(kAll, fs, 1);
    if (in) {
      a.qual_out[static_cast<size_t>(g) * a.ol + t] = static_cast<uint8_t>(fq);
      if ((t & 1) == 0)
        a.pseq_out[static_cast<size_t>(g) * (a.ol >> 1) + (t >> 1)] =
            static_cast<uint8_t>((fs << 4) | fs_next);
    }
    if (t == 0) {
      sh.jobidx[n & 3] = pending;
      int* const mine = sh.last;
      mine[0] = g;
      mine[1] = cls;
      mine[2] = nr;
      mine[3] = nd;
      mine[4] = diff;
      mine[5] = minc;
      mine[6] = fs;
      mine[7] = fq;
    }
  }

  // ---- per-class escape counts: the last block to finish writes them.
  // The wire warp added its last job's count just before the loop ended:
  // fence it and wait for it before thread 0 takes the block's ticket.
  __threadfence();
  __syncthreads();
  if (t != 0) return;
  const unsigned ticket = atomicAdd(reinterpret_cast<unsigned*>(&a.scratch[a.nb]), 1u);
  if (ticket == gridDim.x - 1) {
    __threadfence();
    for (int c = 0; c < a.nb; ++c) {
      const unsigned v = static_cast<unsigned>(atomicAdd(&a.scratch[c], 0));
      uint8_t* d8 = bads + 4 * static_cast<size_t>(c);
      d8[0] = static_cast<uint8_t>(v & 0xFF);
      d8[1] = static_cast<uint8_t>((v >> 8) & 0xFF);
      d8[2] = static_cast<uint8_t>((v >> 16) & 0xFF);
      d8[3] = static_cast<uint8_t>(v >> 24);
    }
  }
}

size_t dyn_smem(int L) {
  return static_cast<size_t>(2) * (kStage * 3 * L + L + 16) +
         static_cast<size_t>(kStage) * 3 * L;
}

int threads_for(int L) { return ((L + 31) / 32) * 32; }

// Resident blocks on the whole card at width L, per device and L / 16
// (0: not asked yet); the occupancy query costs more than a launch.
constexpr int kMaxDevices = 64;
std::atomic<int> resident[kMaxDevices][17];

// Blocks of the persistent grid for Jt jobs at width L on the current
// device: resident blocks per SM times the SMs, at most Jt; 0 on error.
int grid_for(int L, int Jt, cudaError_t* err) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  std::atomic<int>* cached =
      e == cudaSuccess && dev < kMaxDevices ? &resident[dev][L >> 4] : nullptr;
  int n = cached != nullptr ? cached->load(std::memory_order_relaxed) : 0;
  if (e == cudaSuccess && n == 0) {
    const size_t smem = dyn_smem(L);
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(vote_window_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vote_window_kernel,
                                                        threads_for(L), smem);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    n = per_sm * sms;
    if (e == cudaSuccess && cached != nullptr) cached->store(n, std::memory_order_relaxed);
  }
  *err = e;
  if (e != cudaSuccess) return 0;
  return n < Jt ? n : Jt;
}

}  // namespace

// Members a job stages with it (kStage); a job of more votes the rest in
// chunks of as many.
extern "C" int gc_vote_window_stage() { return kStage; }

// The persistent grid gc_vote_window launches for Jt jobs at width L on
// the current device (0 on error).
extern "C" int gc_vote_window_grid(int L, int Jt) {
  if (L <= 0 || L > 256 || Jt <= 0) return 0;
  cudaError_t e;
  return grid_for(L, Jt, &e);
}

// Launch on `stream`; returns a cudaError_t (0 = success).
// seq/qual u8 [N, L], score i8 [N, L] (16-byte aligned, L % 16 == 0,
// L <= 256); the refbase sources: genome u8 [G] (G >= L, 16-byte aligned
// allocation), per job of the window gp, hm, jp i32 [Jw], host rows hr u8
// [nh, L] (16-byte aligned, nh >= 1); jobs i32 [6, Jt], one row per
// field: base row, member count <= K, job length, refbase row, class
// index < nb, class size K; qtable u8 [16] or null; outputs: flat u8
// (the wire buffer of all Jt jobs and nb classes), pseq
// u8 [Jt, ol/2], qual_out u8 [Jt, ol]; scratch i32 [nb + 2] (zeroed
// here). 2 <= ol <= L, ol even.
extern "C" int gc_vote_window(const void* seq, const void* qual,
                              const void* score, const void* genome,
                              const void* gp, const void* hm, const void* jp,
                              const void* hr, const void* jobs,
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
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * (nb + 2), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = grid_for(L, Jt, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.seq = static_cast<const uint8_t*>(seq);
  a.qual = static_cast<const uint8_t*>(qual);
  a.score = static_cast<const int8_t*>(score);
  a.ref.genome = static_cast<const uint8_t*>(genome);
  a.ref.gp = static_cast<const int32_t*>(gp);
  a.ref.hm = static_cast<const int32_t*>(hm);
  a.ref.jp = static_cast<const int32_t*>(jp);
  a.ref.hr = static_cast<const uint8_t*>(hr);
  a.ref.G = G;
  a.ref.nh = nh;
  a.jobs = static_cast<const int32_t*>(jobs);
  a.qtable = static_cast<const uint8_t*>(qtable);
  a.flat = static_cast<uint8_t*>(flat);
  a.pseq_out = static_cast<uint8_t*>(pseq);
  a.qual_out = static_cast<uint8_t*>(qual_out);
  a.scratch = static_cast<int32_t*>(scratch);
  a.N = N;
  a.L = L;
  a.Jw = Jw;
  a.Jt = Jt;
  a.nb = nb;
  a.ol = ol;
  a.hi = hi;
  a.mod = mod;
  a.lo = lo;
  a.bsr = bsr;
  a.rnum = rnum;
  a.rden = rden;
  vote_window_kernel<<<grid, threads_for(L), dyn_smem(L), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
