"""Overlap scoring and the [J, K, L] vote (port of
gencore_tpu/core/kernels.py).

* `score_map_kernel`, `score_map_kernel_packed` — Pair::computeScore
  (pair.cpp:88-172) as a per-row map (K5): every read row looks up its
  mate row and computes its own scores and rewritten quals, the geometry
  in seven per-row arrays or packed into one word per row. XLA programs in
  the JAX package (no Pallas kernel). On CUDA tensors both launch
  `csrc/upload_dense.cu`'s gc_score_map (`score_map`), the dense staging
  route's score map; on CPU tensors their plain twins `score_map_plain`
  and `score_map_packed_plain` run. The mate shift is a direct index
  gather; the JAX version's log2(L) lane-roll ladder existed only because
  a per-element gather scalarizes on a TPU. The gather index
  (j + shift) mod L is exactly what that roll ladder computed.
* `upload_unpack` — `csrc/upload_dense.cu`'s gc_upload_unpack (K12): the
  dense staging unpacked into the resident matrices, for
  engine._upload_unpack_fn on CUDA tensors (its twin
  engine._upload_unpack_plain); `vote.pinned_parts` sends host arrays up
  in one pinned copy.
* `fused_vote_kernel` / `_vote_core` — Group::makeConsensus over members
  gathered from the device matrices with per-member lenDiff shifts, with
  all 16 nt16 bins (`full_bins=True`, data with codes outside =ACGTN) or
  the six =ACGTN bins. On CPU tensors it is the plain PyTorch translation
  of the JAX functions; on CUDA tensors `full_bins=True` launches the
  hand-written kernel (`vote.vote_full`, csrc/vote.cu with the Bins16
  rules), whose twin is this plain version.
* `upload_score` — the window's upload rebuild and overlap scoring (the
  JAX package's one jitted program engine._upload_score_fn: K4, then K5
  `score_map_kernel_packed` or K6, the qual tier of a scored-row mask)
  through `csrc/upload_score.cu`: the staging's 15 host arrays go up in
  one pinned copy (`upload_score_pack`, in their own dtypes) and one
  launch rebuilds and scores every row. CUDA only; its twin is the plain
  program engine._upload_score_plain, which `engine._upload_score_fn`
  runs on CPU tensors.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction

import numpy as np
import torch

from gencore_tpu_torch.core import vote
from gencore_tpu_torch.utils import tracing

I32 = torch.int32

# launches of csrc/upload_score.cu (`upload_score`) and of
# csrc/upload_dense.cu (`upload_unpack`, `score_map`), CUDA tensors only
UPLOAD_SCORE_LAUNCHES = 0
UPLOAD_UNPACK_LAUNCHES = 0
SCORE_MAP_LAUNCHES = 0


def ratio_fraction(score_percent_req: float) -> tuple[int, int]:
    """Exact small fraction for the ratio threshold: the integer predicate
    top*den < num*total replaces the reference's double compare. Same rule
    as gencore_tpu.core.kernels.ratio_fraction, which cannot be imported
    without JAX (tests/test_torch_kernels.py holds the two equal)."""
    f = Fraction(str(float(score_percent_req))).limit_denominator(10**6)
    return f.numerator, f.denominator


def _qual2score(q, hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """reference pair.cpp:77-86 tiering, on an int32 tensor."""
    out = torch.full_like(q, s_bad, dtype=I32)
    out = torch.where(q >= lo, torch.full_like(out, s_lo), out)
    out = torch.where(q >= mod, torch.full_like(out, s_mod), out)
    return torch.where(q >= hi, torch.full_like(out, s_hi), out)


def score_map_kernel(seq_all, qual_all, mate_row, my_start, mate_start,
                     cmp_len, my_len, is_left, scored, *, hi, mod, lo, s_hi,
                     s_mod, s_lo, s_bad):
    """Per-row overlap scoring over the device-resident matrices.

    seq_all/qual_all u8 [N, L]; per-row mate_row, my_start, mate_start,
    cmp_len, my_len (int), is_left, scored (bool) [N]. Returns
    (score_all i8 [N, L], qual_all' u8 [N, L]) exactly as the JAX
    score_map_kernel. CPU tensors run the plain twin `score_map_plain`;
    CUDA tensors launch the kernel (`score_map`: int32 geometry, u8 or
    bool flags)."""
    kw = dict(hi=hi, mod=mod, lo=lo, s_hi=s_hi, s_mod=s_mod, s_lo=s_lo,
              s_bad=s_bad)
    dev = seq_all.device
    if dev.type == "cuda":
        return score_map(seq_all, qual_all, mate_row, my_len,
                         my_start=my_start, mate_start=mate_start,
                         cmp_len=cmp_len, is_left=is_left, scored=scored,
                         **kw)
    if dev.type != "cpu":
        raise ValueError(f"score_map_kernel: unsupported device {dev}")
    return score_map_plain(seq_all, qual_all, mate_row, my_start, mate_start,
                           cmp_len, my_len, is_left, scored, **kw)


def score_map_plain(seq_all, qual_all, mate_row, my_start, mate_start,
                    cmp_len, my_len, is_left, scored, *, hi, mod, lo, s_hi,
                    s_mod, s_lo, s_bad):
    """score_map_kernel in plain PyTorch on any device: the twin of
    csrc/upload_dense.cu's gc_score_map."""
    N, L = seq_all.shape
    dev = seq_all.device
    j = torch.arange(L, dtype=I32, device=dev)[None, :]
    ms = my_start.to(I32)[:, None]
    cl = cmp_len.to(I32)[:, None]
    q = qual_all.to(I32)
    mr = mate_row.to(torch.int64).clamp(0, N - 1)
    delta = torch.remainder(mate_start.to(I32) - my_start.to(I32), L)
    idx = torch.remainder(j + delta[:, None], L).to(torch.int64)
    p_seq = seq_all[mr].gather(1, idx)
    p_q = qual_all[mr].gather(1, idx).to(I32)
    in_ov = (j >= ms) & (j < ms + cl) & (j < my_len.to(I32)[:, None])

    def q2s(x):
        return _qual2score(x, hi, mod, lo, s_hi, s_mod, s_lo, s_bad)

    zero = torch.zeros((), dtype=I32, device=dev)
    match = seq_all == p_seq
    ov_match = q2s(torch.div(q + p_q, 2, rounding_mode="floor")) + 4
    win = (q > p_q) | (is_left.bool()[:, None] & (q == p_q))
    ov_mis = torch.where(win, q2s(q - p_q) - 3, zero)
    score = torch.where(in_ov, torch.where(match, ov_match, ov_mis), q2s(q))
    sc = scored.bool()[:, None]
    score = torch.where(sc, score, torch.full_like(score, s_mod)).to(torch.int8)
    new_q = torch.where(sc & in_ov & ~match,
                        torch.clamp(q - p_q, min=0), q).to(torch.uint8)
    return score, new_q


def score_map_kernel_packed(seq_all, qual_all, lens_dev, mate_row, meta, *,
                            hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """score_map_kernel with the per-row geometry packed into one integer
    (my_start 8b | mate_start 8b | cmp_len 9b | is_left 1b | scored 1b)
    and the lengths taken from the device lens array. CPU tensors run the
    plain twin `score_map_packed_plain`; CUDA tensors launch the kernel
    (`score_map` with meta: int32 lens, mate rows and meta)."""
    kw = dict(hi=hi, mod=mod, lo=lo, s_hi=s_hi, s_mod=s_mod, s_lo=s_lo,
              s_bad=s_bad)
    dev = seq_all.device
    if dev.type == "cuda":
        return score_map(seq_all, qual_all, mate_row, lens_dev, meta=meta,
                         **kw)
    if dev.type != "cpu":
        raise ValueError(f"score_map_kernel_packed: unsupported device {dev}")
    return score_map_packed_plain(seq_all, qual_all, lens_dev, mate_row, meta,
                                  **kw)


def score_map_packed_plain(seq_all, qual_all, lens_dev, mate_row, meta, *,
                           hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """score_map_kernel_packed in plain PyTorch on any device: the twin of
    gc_score_map's packed form."""
    meta = meta.to(torch.int64)
    return score_map_plain(
        seq_all, qual_all, mate_row, meta & 0xFF, (meta >> 8) & 0xFF,
        (meta >> 16) & 0x1FF, lens_dev, ((meta >> 25) & 1).bool(),
        ((meta >> 26) & 1).bool(), hi=hi, mod=mod, lo=lo, s_hi=s_hi,
        s_mod=s_mod, s_lo=s_lo, s_bad=s_bad)


def _dense_checks(fn, dev, specs):
    """Each tensor of specs ({name: (tensor, dtypes, shape)}) on `dev`,
    contiguous, of one of the dtypes and the shape; raises otherwise."""
    for name, (t, dtypes, shape) in specs.items():
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{fn}: {name} must be a tensor on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected one of "
                            f"{[str(d) for d in dtypes]}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")


def score_map(seq_all, qual_all, mate_row, my_len, *, meta=None,
              my_start=None, mate_start=None, cmp_len=None, is_left=None,
              scored=None, hi, mod, lo, s_hi, s_mod, s_lo, s_bad):
    """csrc/upload_dense.cu's gc_score_map on CUDA tensors: with `meta`
    the packed form (score_map_kernel_packed; my_len the lengths), else
    the int32 form (score_map_kernel). seq_all/qual_all u8 [N, L], L a
    multiple of 16, 16-byte aligned; mate_row, my_len, meta, my_start,
    mate_start, cmp_len int32 [N]; is_left, scored u8 or bool [N]. Returns
    new (score i8 [N, L], qual u8 [N, L]), equal byte for byte to the
    plain twin's."""
    dev = seq_all.device
    if dev.type != "cuda":
        raise ValueError(f"score_map: needs CUDA tensors, got {dev}")
    if seq_all.dim() != 2:
        raise ValueError("score_map: seq_all must be [N, L]")
    N, L = seq_all.shape
    if L == 0 or L % 16:
        raise ValueError(f"score_map: L={L} must be a positive multiple "
                         "of 16")
    i32, flag = (torch.int32,), (torch.uint8, torch.bool)
    specs = {"seq_all": (seq_all, (torch.uint8,), (N, L)),
             "qual_all": (qual_all, (torch.uint8,), (N, L)),
             "mate_row": (mate_row, i32, (N,)), "my_len": (my_len, i32, (N,))}
    packed = meta is not None
    if packed:
        specs["meta"] = (meta, i32, (N,))
    else:
        specs.update(my_start=(my_start, i32, (N,)),
                     mate_start=(mate_start, i32, (N,)),
                     cmp_len=(cmp_len, i32, (N,)),
                     is_left=(is_left, flag, (N,)),
                     scored=(scored, flag, (N,)))
    _dense_checks("score_map", dev, specs)
    if seq_all.data_ptr() % 16 or qual_all.data_ptr() % 16:
        raise ValueError("score_map: seq_all and qual_all must start at "
                         "16-byte aligned addresses (the kernel loads 16 "
                         "bytes at a time)")
    if N * (L // 16) >= 2**31:
        raise ValueError(f"score_map: [{N}, {L}] does not fit the kernel's "
                         "grid")
    score = torch.empty((N, L), dtype=torch.int8, device=dev)
    qual = torch.empty((N, L), dtype=torch.uint8, device=dev)
    if N == 0:
        return score, qual

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = vote.build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with tracing.span("launch.gc_score_map", rows=N, L=L,
                          packed=int(packed)):
            err = lib.gc_score_map(
                seq_all.data_ptr(), qual_all.data_ptr(),
                mate_row.data_ptr(), ptr(meta), ptr(my_start),
                ptr(mate_start), ptr(cmp_len), my_len.data_ptr(),
                ptr(is_left), ptr(scored), score.data_ptr(),
                qual.data_ptr(), N, L, int(packed), hi, mod, lo, s_hi,
                s_mod, s_lo, s_bad, stream)
    if err != 0:
        raise RuntimeError(f"gc_score_map launch failed: cudaError_t {err}")
    global SCORE_MAP_LAUNCHES
    SCORE_MAP_LAUNCHES += 1
    return score, qual


# the dense staging's modes: positions per byte, and gc_upload_unpack's
# mode bits
SEQ_MODES = {"2bit": (4, 1), "4bit": (2, 0)}
QUAL_MODES = {"2bit": (4, 2), "4bit": (2, 4), "raw": (1, 0)}


def upload_unpack(seq_up, qual_up, lens, qtable, *, w, L, seq_mode,
                  qual_mode):
    """csrc/upload_dense.cu's gc_upload_unpack on CUDA tensors: the dense
    staging (seq_up u8 [n, sw] 2-bit or 4-bit, qual_up u8 [n, qw] 2-bit
    or 4-bit indices or raw [n, w], lens int32 [n], qtable u8 [16]) to
    the resident (seq u8 [n, L], qual u8 [n, L], lens int32 [n]), equal
    byte for byte to engine._upload_unpack_plain's. L is a multiple of
    16; w <= L any width the staging holds."""
    dev = seq_up.device
    if dev.type != "cuda":
        raise ValueError(f"upload_unpack: needs CUDA tensors, got {dev}")
    if seq_mode not in SEQ_MODES or qual_mode not in QUAL_MODES:
        raise ValueError(f"upload_unpack: unknown modes {seq_mode!r}, "
                         f"{qual_mode!r}")
    if seq_up.dim() != 2 or qual_up.dim() != 2:
        raise ValueError("upload_unpack: seq_up and qual_up must be 2-D")
    n, sw = seq_up.shape
    qw = qual_up.shape[1]
    u8 = (torch.uint8,)
    _dense_checks("upload_unpack", dev, {
        "seq_up": (seq_up, u8, (n, sw)), "qual_up": (qual_up, u8, (n, qw)),
        "lens": (lens, (torch.int32,), (n,)),
        "qtable": (qtable, u8, (16,))})
    s_per, s_bit = SEQ_MODES[seq_mode]
    q_per, q_bit = QUAL_MODES[qual_mode]
    if not 0 < w <= L or L % 16:
        raise ValueError(f"upload_unpack: needs 0 < w={w} <= L={L}, L a "
                         "multiple of 16")
    if s_per * sw < w or q_per * qw < w or (qual_mode == "raw" and qw != w):
        raise ValueError(f"upload_unpack: rows of {sw} and {qw} bytes do "
                         f"not hold {w} {seq_mode} bases and {qual_mode} "
                         "quals")
    if n * (L // 16) >= 2**31:
        raise ValueError(f"upload_unpack: [{n}, {L}] does not fit the "
                         "kernel's grid")
    seq = torch.empty((n, L), dtype=torch.uint8, device=dev)
    qual = torch.empty((n, L), dtype=torch.uint8, device=dev)
    lens_out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return seq, qual, lens_out
    lib = vote.build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with tracing.span("launch.gc_upload_unpack", rows=n, w=w, L=L):
            err = lib.gc_upload_unpack(
                seq_up.data_ptr(), qual_up.data_ptr(), lens.data_ptr(),
                qtable.data_ptr(), seq.data_ptr(), qual.data_ptr(),
                lens_out.data_ptr(), n, w, L, sw, qw, s_bit | q_bit, stream)
    if err != 0:
        raise RuntimeError(f"gc_upload_unpack launch failed: cudaError_t "
                           f"{err}")
    global UPLOAD_UNPACK_LAUNCHES
    UPLOAD_UNPACK_LAUNCHES += 1
    return seq, qual, lens_out


NT16_BINS = tuple(range(16))
ACGTN_BINS = vote.BINS   # (0, 1, 2, 4, 8, 15)


def _vote_core(seq, qual, score, valid, pos_valid, refbase, hi, mod, lo,
               base_score_req, ratio_num, ratio_den, full_bins):
    """The vote of gencore_tpu.core.kernels._vote_core, line for line.

    seq/qual u8 [J, K, L], score int [J, K, L], valid bool [J, K],
    pos_valid bool [J, L], refbase u8 [J, L] (0 = no reference base).
    What sets it apart from the Pallas vote (`vote.vote_core_plain`):
    members count where valid & pos_valid (no sentinel), a stored 255
    falls in no bin but its score counts in the total, `full_bins=True`
    elects over all 16 bins with no virtual empty bin, `changed` is masked
    by pos_valid (outside it the template's qual is kept), and diff, minc
    and the rollback (minc > 5) are per job. Returns (new_seq u8 [J, L],
    new_qual u8 [J, L], diff i32 [J], minc i32 [J])."""
    J, K, L = seq.shape
    dev = seq.device
    present = valid.bool()[:, :, None] & pos_valid.bool()[:, None, :]
    zero = torch.zeros((), dtype=I32, device=dev)
    sc = torch.where(present, score.to(I32), zero)
    ql = torch.where(present, qual.to(I32), zero)
    bins = NT16_BINS if full_bins else ACGTN_BINS

    counts_b, scores_b, quals_b, topq_b = [], [], [], []
    for b in bins:
        m = present & (seq == b)
        counts_b.append(m.sum(dim=1, dtype=I32))
        scores_b.append(torch.where(m, sc, zero).sum(dim=1, dtype=I32))
        mq = torch.where(m, ql, zero)
        quals_b.append(mq.sum(dim=1, dtype=I32))
        topq_b.append(mq.amax(dim=1))
    total_score = sc.sum(dim=1, dtype=I32)

    def full(x):
        return torch.full((J, L), x, dtype=I32, device=dev)

    neg_inf = full(-0x7FFFFFFF)
    # top election: lexmax of (score, qual sum, bin), later bins win ties
    # (group.cpp:394-402)
    top_base, top_score, top_qs = full(0), neg_inf, full(0)
    for bi, b in enumerate(bins):
        better = (scores_b[bi] > top_score) | (
            (scores_b[bi] == top_score) & (quals_b[bi] >= top_qs))
        top_base = torch.where(better, full(b), top_base)
        top_score = torch.where(better, scores_b[bi], top_score)
        top_qs = torch.where(better, quals_b[bi], top_qs)
    if not full_bins:
        # the always-empty bins as one virtual candidate (score 0, qual 0,
        # bin 14)
        vb = (top_score < 0) | ((top_score == 0) & (top_qs <= 0)
                                & (top_base < 14))
        top_base = torch.where(vb, full(14), top_base)
        top_score = torch.where(vb, zero, top_score)
        top_qs = torch.where(vb, zero, top_qs)

    # second election, skipping the top bin (group.cpp:407-416)
    sec_base, sec_score, sec_qs = full(0), neg_inf, full(0)
    for bi, b in enumerate(bins):
        better = (top_base != b) & ((scores_b[bi] > sec_score) | (
            (scores_b[bi] == sec_score) & (quals_b[bi] >= sec_qs)))
        sec_base = torch.where(better, full(b), sec_base)
        sec_score = torch.where(better, scores_b[bi], sec_score)
        sec_qs = torch.where(better, quals_b[bi], sec_qs)
    if not full_bins:
        vidx = torch.where(top_base == 14, full(13), full(14))
        vb = (sec_score < 0) | ((sec_score == 0) & (sec_qs <= 0)
                                & (sec_base < vidx))
        sec_base = torch.where(vb, vidx, sec_base)
        sec_score = torch.where(vb, zero, sec_score)

    def take_bin(arrs, idx):
        out = full(0)
        for bi, b in enumerate(bins):
            out = torch.where(idx == b, arrs[bi], out)
        return out

    top_num = take_bin(counts_b, top_base)
    top_qual = take_bin(topq_b, top_base)
    sec_num = take_bin(counts_b, sec_base)
    sec_qual_sum = take_bin(quals_b, sec_base)

    # early accept and the needToCheckRef rules (group.cpp:419-467), the
    # ratio test as an exact integer cross-multiplication
    accept_early = ((sec_num == 0) & (top_score >= base_score_req)
                    & (top_qual >= mod))
    need_ref = (sec_num == 0) & ~accept_early
    need_ref |= (sec_num == 1) & torch.where(
        sec_qual_sum <= lo, (top_num < 2) & (top_qual < hi),
        (top_num < 3) | (top_qual < hi))
    need_ref |= (sec_num > 1) & ((top_score * ratio_den
                                  < ratio_num * total_score)
                                 | (top_qual < mod))
    need_ref |= (top_score < base_score_req) | (top_qual <= lo)
    has_ref = refbase != 0
    do_ref = need_ref & has_ref & ~accept_early

    # ref-consistent evidence (group.cpp:470-501)
    ref_m = present & (seq == refbase[:, None, :])
    rq = torch.where(ref_m, ql, zero)
    ref_base_qual = rq.amax(dim=1)
    any_high_ref = (rq >= hi).any(dim=1) & ref_m.any(dim=1)

    rb = refbase.to(I32)
    top_base2 = torch.where(do_ref & any_high_ref, rb, top_base)
    top_base2 = torch.where(do_ref & (top_qual < mod), rb, top_base2)
    top_qual2 = torch.where(do_ref & (top_base2 == rb), ref_base_qual,
                            top_qual)

    pv = pos_valid.bool()
    out_base = seq[:, 0, :].to(I32)
    out_qual_orig = qual[:, 0, :].to(I32)
    changed = ~accept_early & (out_base != top_base2) & pv
    cand_seq = torch.where(changed, top_base2, out_base)
    cand_qual = torch.where(pv, torch.where(accept_early, top_qual,
                                            top_qual2), out_qual_orig)
    diff = changed.sum(dim=1, dtype=I32)
    inner = torch.where(out_base == rb, full(1),
                        torch.where(top_base2 == rb, full(-1), zero))
    minc = torch.where(changed & has_ref, inner, zero).sum(dim=1, dtype=I32)
    rollback = (minc > 5)[:, None]
    new_seq = torch.where(rollback, out_base, cand_seq).to(torch.uint8)
    new_qual = torch.where(rollback, out_qual_orig, cand_qual).to(torch.uint8)
    return new_seq, new_qual, diff, minc


def fused_vote_kernel(seq_all, qual_all, score_all, rows, shifts, valid,
                      job_len, refbase, *, hi, mod, lo, base_score_req,
                      ratio_num, ratio_den, full_bins=True):
    """Gather each job's members from the device matrices with their
    lenDiff shifts (group.cpp:376-385) and vote; the final rows (template
    row with the voted prefix, rolled back where minc > 5) plus diff and
    minc, as gencore_tpu.core.kernels.fused_vote_kernel returns them.

    seq_all/qual_all u8 [N, L], score_all i8 [N, L]; rows/shifts int
    [J, K] (member rows; shift >= 0), valid bool [J, K], job_len int [J],
    refbase u8 [J, L]. Member loads read clip(shift + pos, 0, L-1) of row
    clamp(rows, 0, N-1): the JAX version's take would fill for a row
    outside the matrix, which no caller passes.
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (`vote.vote_full`, full_bins=True only: =ACGTN data takes the
    six-bin kernels of `vote.pallas_vote_window` and
    `vote.pallas_vote_gathered`)."""
    dev = seq_all.device
    if dev.type == "cuda":
        if not full_bins:
            raise ValueError("fused_vote_kernel: on CUDA only full_bins=True "
                             "has a kernel (=ACGTN data votes through "
                             "vote.pallas_vote_gathered)")
        return vote.vote_full(
            seq_all, qual_all, score_all, rows, shifts, valid, job_len,
            refbase, hi=hi, mod=mod, lo=lo, base_score_req=base_score_req,
            ratio_num=ratio_num, ratio_den=ratio_den)
    if dev.type != "cpu":
        raise ValueError(f"fused_vote_kernel: unsupported device {dev}")
    return fused_vote_plain(seq_all, qual_all, score_all, rows, shifts,
                            valid, job_len, refbase, hi=hi, mod=mod, lo=lo,
                            base_score_req=base_score_req,
                            ratio_num=ratio_num, ratio_den=ratio_den,
                            full_bins=full_bins)


def fused_vote_plain(seq_all, qual_all, score_all, rows, shifts, valid,
                     job_len, refbase, *, hi, mod, lo, base_score_req,
                     ratio_num, ratio_den, full_bins=True):
    """fused_vote_kernel in plain PyTorch on any device: the twin of the
    Bins16 kernel."""
    N, L = seq_all.shape
    dev = seq_all.device
    l = torch.arange(L, dtype=torch.int64, device=dev)
    idx = (shifts.to(torch.int64)[:, :, None] + l).clamp(0, L - 1)
    flat = rows.to(torch.int64).clamp(0, N - 1)[:, :, None] * L + idx
    gseq = seq_all.reshape(-1)[flat]
    gqual = qual_all.reshape(-1)[flat]
    gscore = score_all.reshape(-1)[flat].to(I32)
    pos_valid = (torch.arange(L, dtype=I32, device=dev)[None, :]
                 < job_len.to(I32)[:, None])
    return _vote_core(gseq, gqual, gscore, valid.bool(), pos_valid,
                      refbase.to(torch.uint8), hi, mod, lo, base_score_req,
                      ratio_num, ratio_den, full_bins)


def consensus_kernel(seq, qual, score, valid, pos_valid, refbase, *, hi, mod,
                     lo, base_score_req, ratio_num, ratio_den, full_bins=True):
    """The vote over members already gathered per job (Group::makeConsensus,
    group.cpp:369-526), as gencore_tpu.core.kernels.consensus_kernel.

    seq/qual u8 [J, K, L] (member 0 is the template; right-mode members
    pre-shifted by lenDiff), score int [J, K, L], valid bool [J, K],
    pos_valid bool [J, L], refbase u8 [J, L] (0 = no reference base).
    Returns (new_seq u8 [J, L], new_qual u8 [J, L], diff i32 [J], minc
    i32 [J]), rolled back to the template row where minc > 5.

    CPU tensors run the plain version (`consensus_plain`). CUDA tensors
    launch the Bins16 kernel through `vote.vote_full`, with the [J, K, L]
    block viewed as J*K rows: it needs full_bins=True, L a multiple of 16,
    scores within int8 and pos_valid a prefix mask (position < job length,
    as every caller builds it); anything else raises."""
    dev = seq.device
    if dev.type == "cpu":
        return consensus_plain(seq, qual, score, valid, pos_valid, refbase,
                               hi=hi, mod=mod, lo=lo,
                               base_score_req=base_score_req,
                               ratio_num=ratio_num, ratio_den=ratio_den,
                               full_bins=full_bins)
    if dev.type != "cuda":
        raise ValueError(f"consensus_kernel: unsupported device {dev}")
    if not full_bins:
        raise ValueError("consensus_kernel: on CUDA only full_bins=True has "
                         "a kernel")
    J, K, L = seq.shape
    job_len = pos_valid.sum(dim=1, dtype=I32)
    prefix = torch.arange(L, dtype=I32, device=dev)[None, :] < job_len[:, None]
    if not bool((prefix == pos_valid.bool()).all()):
        raise ValueError("consensus_kernel: pos_valid is not a prefix mask")
    if score.dtype != torch.int8:
        if score.numel() and (int(score.amin()) < -128
                              or int(score.amax()) > 127):
            raise ValueError("consensus_kernel: scores do not fit int8")
        score = score.to(torch.int8)
    rows = torch.arange(J * K, dtype=I32, device=dev).reshape(J, K)
    return vote.vote_full(
        seq.reshape(J * K, L).contiguous(), qual.reshape(J * K, L).contiguous(),
        score.reshape(J * K, L).contiguous(), rows, torch.zeros_like(rows),
        valid, job_len, refbase, hi=hi, mod=mod, lo=lo,
        base_score_req=base_score_req, ratio_num=ratio_num,
        ratio_den=ratio_den)


def consensus_plain(seq, qual, score, valid, pos_valid, refbase, *, hi, mod,
                    lo, base_score_req, ratio_num, ratio_den, full_bins=True):
    """consensus_kernel in plain PyTorch on any device."""
    return _vote_core(seq, qual, score, valid.bool(), pos_valid.bool(),
                      refbase.to(torch.uint8), hi, mod, lo, base_score_req,
                      ratio_num, ratio_den, full_bins)


# the staging's host arrays in the order of the upload (the genome stays
# resident on the device), with the dtypes the kernel reads; the flags set
# three: lens16 is int32 [2] under const_lens, else u16; mate is u32 under
# mate32, else u16; meta is u8 (a bit per row) under no_overlap, else u32
UPLOAD_PARTS = (("sd", np.uint8), ("src", np.uint16), ("scnt", np.uint8),
                ("epos", np.uint8), ("ecode", np.uint8), ("base", np.uint8),
                ("q_src", np.uint16), ("qd", np.uint8), ("qcnt", np.uint8),
                ("qpos", np.uint8), ("qval", np.uint8), ("lens16", None),
                ("mate", None), ("meta", None), ("gsl", np.int32))
# the program's static flags, in the order of the kernel's flag bits
UPLOAD_FLAGS = ("mode2", "has_sedit", "has_qdense", "has_qedit",
                "const_lens", "has_genome", "no_overlap", "mate32")
_UPLOAD_DIMS = 36     # csrc/upload_score.cu's kDims
_UPLOAD_MAX_GRID = 1280   # csrc/upload_score.cu's kMaxGrid


def upload_score_layout(arrays):
    """Where each of the 15 staging arrays (UPLOAD_PARTS' order) lies in
    the kernel's one upload: {"parts": {name: (byte offset, dtype,
    shape)}, "bar": the offset of the 16 zero bytes the kernel's grid
    barrier counts in, "size": bytes}. Each part starts at a multiple of
    16 bytes, in its own dtype."""
    parts = {}
    off = 0
    for (name, _dt), a in zip(UPLOAD_PARTS, arrays, strict=True):
        a = np.asarray(a)
        parts[name] = (off, a.dtype, a.shape)
        off += -(-a.nbytes // 16) * 16
    return {"parts": parts, "bar": off, "size": off + 16}


def upload_score_pack(arrays, alloc=None):
    """The kernel's one upload, u8: the 15 staging arrays in their own
    dtypes at upload_score_layout's offsets, the gaps and the barrier
    bytes zeroed. Returns (buffer, layout); the buffer comes from
    alloc(size) when given."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    lay = upload_score_layout(arrays)
    buf = (np.empty(lay["size"], dtype=np.uint8) if alloc is None
           else alloc(lay["size"]))
    end = 0
    for (name, _dt), a in zip(UPLOAD_PARTS, arrays):
        off = lay["parts"][name][0]
        buf[end:off] = 0
        buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        end = off + a.nbytes
    buf[end:] = 0
    return buf, lay


def _upload_checks(arrays, flags, w, L):
    """The staging's dtypes and shapes as the kernel reads them; returns
    (n, nd, bw, ns, E, Eq, nq, qw)."""
    a = dict(zip((name for name, _dt in UPLOAD_PARTS), arrays))
    for name, dt in UPLOAD_PARTS:
        want = dt
        if name == "lens16":
            want = np.int32 if flags["const_lens"] else np.uint16
        elif name == "mate":
            want = np.uint32 if flags["mate32"] else np.uint16
        elif name == "meta":
            want = np.uint8 if flags["no_overlap"] else np.uint32
        if a[name].dtype != want:
            raise TypeError(f"upload_score: {name} is {a[name].dtype}, "
                            f"expected {np.dtype(want)}")
    sd, qd = a["sd"], a["qd"]
    if sd.ndim != 2 or qd.ndim != 2:
        raise ValueError("upload_score: sd and qd must be 2-D")
    n = len(a["src"])
    nd, bw = sd.shape
    if not 0 < w <= L <= 256 or L % 16:
        raise ValueError(f"upload_score: needs 0 < w={w} <= L={L} <= 256, "
                         "L a multiple of 16")
    if nd == 0 or (4 if flags["mode2"] else 2) * bw < w:
        raise ValueError(f"upload_score: sd {sd.shape} cannot hold rows of "
                         f"{w} codes")
    need = {"base": n, "mate": n if not flags["no_overlap"] else None,
            "meta": -(-n // 8) if flags["no_overlap"] else n,
            "lens16": 2 if flags["const_lens"] else n}
    if flags["has_sedit"]:
        need["scnt"] = n
    if flags["has_qdense"]:
        need["q_src"] = n
    if flags["has_qedit"]:
        need["qcnt"] = n
    for name, m in need.items():
        if m is not None and len(a[name]) < m:
            raise ValueError(f"upload_score: {name} has {len(a[name])} "
                             f"entries, needs {m}")
    E, Eq = len(a["epos"]), len(a["qpos"])
    if len(a["ecode"]) != E or len(a["qval"]) != Eq:
        raise ValueError("upload_score: edit positions and values differ "
                         "in length")
    if (flags["has_sedit"] and E == 0) or (flags["has_qedit"] and Eq == 0):
        raise ValueError("upload_score: an edit stream is flagged but empty")
    nq, qw = qd.shape
    if flags["has_qdense"] and (nq == 0 or qw != w):
        raise ValueError(f"upload_score: dense qual rows {qd.shape} are not "
                         f"{w} wide")
    ns = len(a["gsl"])
    if flags["has_genome"] and ns == 0:
        raise ValueError("upload_score: genome rows flagged without slots")
    if max(n, nd * bw, E, Eq, nq * max(qw, 1)) >= 2**31:
        raise ValueError("upload_score: a dimension does not fit the "
                         "kernel's int")
    return n, nd, bw, ns, E, Eq, nq, qw


def upload_score(arrays, genome, *, device, w, L, mode2, has_sedit,
                 has_qdense, has_qedit, const_lens, has_genome, no_overlap,
                 hi, mod, lo, s_hi, s_mod, s_lo, s_bad, mate32=False,
                 out=None):
    """csrc/upload_score.cu: the staging's 15 host arrays (UPLOAD_PARTS'
    order, numpy) go to `device` (a CUDA device) in one pinned
    non-blocking copy, and one launch rebuilds the resident matrices and
    scores every row. genome: the device NT16 genome (has_genome), else
    unused. mate32: the mate rows are u32 (windows of more than 65,536
    rows), else u16. out: the three output tensors to write, else new
    ones; the kernel stores 16 bytes at a time, so each must be
    contiguous and 16-byte aligned. Returns (seq u8 [n, L], qual u8
    [n, L] (scored), score i8 [n, L]), equal byte for byte to
    engine._upload_score_plain's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"upload_score: needs a CUDA device, got {dev}")
    flags = dict(zip(UPLOAD_FLAGS, (mode2, has_sedit, has_qdense, has_qedit,
                                     const_lens, has_genome, no_overlap,
                                     mate32)))
    arrays = [np.asarray(x) for x in arrays]
    n, nd, bw, ns, E, Eq, nq, qw = _upload_checks(arrays, flags, w, L)
    G = 0
    if has_genome:
        if not (isinstance(genome, torch.Tensor) and genome.device == dev
                and genome.dtype == torch.uint8 and genome.dim() == 1):
            raise ValueError("upload_score: genome rows need the u8 genome "
                             f"on {dev}")
        G = genome.shape[0]
        if not w <= G < 2**31:
            raise ValueError(f"upload_score: genome of {G} bases for rows "
                             f"of {w}")
    up, lay = vote.pinned_upload(
        lambda alloc: upload_score_pack(arrays, alloc=alloc), dev)
    if out is None:
        out = (torch.empty((n, L), dtype=torch.uint8, device=dev),
               torch.empty((n, L), dtype=torch.uint8, device=dev),
               torch.empty((n, L), dtype=torch.int8, device=dev))
    for t, dt in zip(out, (torch.uint8, torch.uint8, torch.int8),
                     strict=True):
        if (t.dtype != dt or t.shape != (n, L) or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"upload_score: an output must be a contiguous {dt} "
                f"[{n}, {L}] on {dev} at a 16-byte aligned address, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} at "
                f"{t.data_ptr() % 16} past 16")
    seq, qual, score = out
    scratch = torch.empty(2 * n + 2 * _UPLOAD_MAX_GRID, dtype=torch.int32,
                          device=dev)
    bits = sum(1 << i for i, f in enumerate(UPLOAD_FLAGS) if flags[f])
    dims = [_UPLOAD_DIMS, n, w, L, bits, nd, bw, ns, G, E, Eq, nq, qw, hi,
            mod, lo, s_hi, s_mod, s_lo, s_bad]
    dims += [lay["parts"][name][0] for name, _dt in UPLOAD_PARTS]
    dims.append(lay["bar"])
    c_dims = (ctypes.c_int * _UPLOAD_DIMS)(*(int(x) for x in dims))
    lib = vote.build_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with tracing.span("launch.gc_upload_score", rows=n, w=w, L=L):
            err = lib.gc_upload_score(
                up.data_ptr(), genome.data_ptr() if has_genome else None,
                seq.data_ptr(), qual.data_ptr(), score.data_ptr(),
                scratch.data_ptr(), c_dims, stream)
    if err != 0:
        raise RuntimeError(f"gc_upload_score launch failed: cudaError_t "
                           f"{err}")
    global UPLOAD_SCORE_LAUNCHES
    UPLOAD_SCORE_LAUNCHES += 1
    return seq, qual, score
