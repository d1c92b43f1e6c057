"""Consensus vote: the hand-written CUDA kernels, their plain twins, and
the entry points around them (port of gencore_tpu/core/pallas_vote.py).
On CUDA tensors every entry point's whole body is one hand kernel; on CPU
tensors it runs the kernel's plain twin.

* `pallas_vote_window` — EVERY fast vote bucket of one window, the main
  path: refbase assembly, vote, rollback, nibble packing and the sparse
  wire encoding. On CUDA tensors it launches `csrc/vote_window.cu` once
  per window (`vote_window`, persistent blocks); on CPU tensors it runs
  the kernel's plain twin `vote_window_plain`, the composition of
  `refbase_combine`, `vote_core_plain`, `_epilogue_core` and
  `concat_sparse` (a port of _pallas_window_all).
* `pallas_vote_gathered`, `pallas_vote` — the per-bucket entry points,
  with the JAX package's names and layouts at their boundaries: the vote
  over K member rows read by index from the device-resident [N, L]
  matrices (or from the host-gathered [K, S, L] block) plus the epilogue.
  On CUDA tensors they launch `csrc/vote.cu`'s gathered entry
  (`vote_gathered`: the Bins6 rules, each job's members split across up
  to 16 CTAs, `split_size`, the epilogue where each job is decided); on
  CPU tensors its plain twin `vote_gathered_plain` (`vote_core_plain`
  then `_epilogue_core`). The gathered entry takes each job's refbase row
  as a [J, L] tensor or, with `refsrc=`, by its index in the window's
  rows, read where they lie from the refbase sources (the genome slice
  or a host row, what the JAX engine's _refbase_combine_fn assembles,
  K11); `window_refsrc` sends a window's sources up once for all its
  buckets, and `pallas_vote_gathered` a bucket's host arrays in one
  pinned copy.
* `vote_full` — the full-bins vote of kernels.fused_vote_kernel (K9: all
  16 nt16 bins, lenDiff shifts, per-job rollback) through the Bins16
  instantiation of `csrc/vote.cu`; CUDA tensors only (its twin is
  kernels.fused_vote_plain).
* `vote_core` — `csrc/vote.cu`'s vote alone (its four int32 [J, L]
  arrays, what the Pallas `_pallas_core` returns); no path of the port
  calls it: chip_smoke.py times it as the vote half of the composition
  `vote_gathered` replaced. `vote_core_plain` is the plain vote (a port of
  the Pallas `_vote_block`).
* `_epilogue_core` — per-read rollback (group.cpp:538-566), nibble packing
  and the sparse wire encoding, in plain PyTorch (XLA in the JAX package):
  the plain twins' half of what the kernels fuse.
* `refbase_combine` — the refbase rows of a window's jobs in plain
  PyTorch: the twin of the rows the window kernel and the gathered entry
  read where they lie (`refbase_rows` for a source form).

Only the device of the tensors selects between a kernel and its twin.
The kernel library builds at first use from `gencore_tpu_torch/csrc/*.cu`
with nvcc for sm_90a into `build/gencore_tpu_torch/` (keyed by a hash of
the sources, headers included; one nvcc per source, run in parallel) and
is bound with ctypes. A missing nvcc or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from gencore_tpu_torch.utils import tracing

BINS = (0, 1, 2, 4, 8, 15)  # non-empty nt16 bins of =ACGTN data
SENTINEL = 255              # member-absent marker (never a bin or refbase)
NEG_INF = -0x7FFFFFFF

# sparse wire-encoding caps (same values and layout as the JAX package):
# inline seq edits / qual runs per job; jobs exceeding either are pulled
# densely by the collector. SPARSE_DIFFS must stay even (bases pack 2/byte).
SPARSE_DIFFS = 4
SPARSE_RUNS = 10

# kernel launches, CUDA tensors only: `vote_gathered` (csrc/vote.cu, Bins6
# with the epilogue; REFSRC_LAUNCHES those of them that read the refbase
# rows from their sources), `vote_full` (csrc/vote.cu, Bins16),
# `vote_window` (csrc/vote_window.cu) and `vote_core` (csrc/vote.cu, the
# vote alone); a vote.cu launch with a split counts once
LAUNCHES = 0
REFSRC_LAUNCHES = 0
FULL_LAUNCHES = 0
WINDOW_LAUNCHES = 0
VOTE_ONLY_LAUNCHES = 0

SMS = 132           # H100 SXM streaming multiprocessors
MAX_SPLIT = 16      # CTAs per job

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "gencore_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()
# nvcc's stderr of the build this process made (ptxas register/spill
# report), or "" when the library was already built
BUILD_LOG = ""


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "CUDA kernels of gencore_tpu_torch cannot build")
    return nvcc


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    """Path of the kernel library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                      + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgencore_kernels_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> str:
    """One nvcc per source, all started together, then one link; returns
    the compilers' stderr (ptxas register/spill report)."""
    nvcc = _find_nvcc()
    tmp = f"{path}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    log = []
    failed = []
    for cmd, pr in zip(cmds, procs):
        _, err = pr.communicate()
        log.append(err)
        if pr.returncode != 0:
            failed.append(f"nvcc failed (exit {pr.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            failed.append(f"nvcc link failed (exit {r.returncode}):\n"
                          f"{' '.join(cmd)}\n{r.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, path)
    return "".join(log)


def build_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            BUILD_LOG = _compile(path)
        lib = ctypes.CDLL(path)
        P = ctypes.c_void_p
        I = ctypes.c_int
        lib.gc_vote_epilogue.argtypes = [P] * 28 + [I] * 15 + [P, P]
        lib.gc_vote_epilogue.restype = ctypes.c_int
        lib.gc_vote.argtypes = [P] * 10 + [I] * 11 + [P, P]
        lib.gc_vote.restype = ctypes.c_int
        lib.gc_vote_full.argtypes = [P] * 12 + [I] * 11 + [P, P]
        lib.gc_vote_full.restype = ctypes.c_int
        lib.gc_vote_window.argtypes = [P] * 14 + [I] * 14 + [P]
        lib.gc_vote_window.restype = ctypes.c_int
        lib.gc_vote_window_grid.argtypes = [I, I]
        lib.gc_vote_window_grid.restype = ctypes.c_int
        lib.gc_vote_window_stage.argtypes = []
        lib.gc_vote_window_stage.restype = ctypes.c_int
        lib.gc_upload_score.argtypes = [P] * 6 + [ctypes.POINTER(I), P]
        lib.gc_upload_score.restype = ctypes.c_int
        lib.gc_upload_unpack.argtypes = [P] * 7 + [I] * 6 + [P]
        lib.gc_upload_unpack.restype = ctypes.c_int
        lib.gc_score_map.argtypes = [P] * 12 + [I] * 10 + [P]
        lib.gc_score_map.restype = ctypes.c_int
        _lib = lib
        return lib


def _thresholds(hi, mod, lo, base_score_req, ratio_num, ratio_den):
    return dict(hi=int(hi), mod=int(mod), lo=int(lo), bsr=int(base_score_req),
                rnum=int(ratio_num), rden=int(ratio_den))


def split_size(K, J):
    """CTAs per job for csrc/vote.cu: 1 for buckets of K <= 64, else the
    least power of two that gives J * C >= two waves of the card's SMs,
    while each CTA keeps >= 32 members, at most MAX_SPLIT."""
    c = 1
    if K > 64:
        while c < MAX_SPLIT and J * c < 2 * SMS and K // (2 * c) >= 32:
            c *= 2
    return c


def _check(fn, specs, dev):
    """Device, dtype, shape and contiguity of each (name, tensor, dtype,
    shape) the kernel reads."""
    for name, t, dt, shape in specs:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def _check_rows(fn, seq_src, qual_src, score_src, K, J):
    N, L = seq_src.shape
    if N == 0 or K == 0:
        raise ValueError(f"{fn}: needs at least one source row and member")
    if max(K, J, L, N) >= 2**31:
        raise ValueError(f"{fn}: a dimension does not fit the kernel's int")
    if L % 16:
        raise ValueError(f"{fn}: L={L} must be a multiple of 16 (16-byte "
                         "row copies)")
    for name, t in (("seq_src", seq_src), ("qual_src", qual_src),
                    ("score_src", score_src)):
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def _launch(fn, lib_fn, ptrs, ints, K, J, L, fields, dev):
    """Launch a vote.cu entry with split_size(K, J) CTAs per job and, for a
    split, int32 scratch for the partial accumulators."""
    split = split_size(K, J)
    part = (torch.empty((split, J, fields, L), dtype=torch.int32, device=dev)
            if split > 1 else None)
    with torch.cuda.device(dev), \
            tracing.span("launch." + fn, J=J, K=K, L=L, split=split):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib_fn(*ptrs, *ints, split,
                     None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")


def _out_len(fn, out_len, L, sparse):
    """The output length ol = min(out_len, L) the kernels cut at."""
    ol = L if out_len is None else min(out_len, L)
    if ol < 2 or ol % 2:
        raise ValueError(f"{fn}: output length {ol} must be even, >= 2")
    if sparse and ol > 256:
        raise ValueError(f"{fn}: the sparse encoding needs an output length "
                         f"<= 256 (positions fit a byte), got {ol}")
    return ol


def _ref_forms(fn, refbase, refsrc, J, L):
    """The gathered entry's refbase arguments: (the _check specs, the
    kernel's pointers refbase, ridx, genome, gp, hm, jp, hr, and Jw, G,
    nh). Without refsrc, refbase u8 [J, L]; refsrc (genome, gp, hm, jp,
    hr, ridx): row ridx[j] (i32 [J], clamped to [0, Jw - 1]) of the rows
    these sources give (refbase_combine), genome u8 [G] (G >= L), gp, hm,
    jp i32 [Jw], hr u8 [nh, L]."""
    I32 = torch.int32
    if refsrc is None:
        if refbase is None:
            raise ValueError(f"{fn}: needs refbase or refsrc")
        return ([("refbase", refbase, torch.uint8, (J, L))],
                [refbase] + [None] * 6, J, 0, 0)
    if refbase is not None:
        raise ValueError(f"{fn}: refbase and refsrc both given")
    if len(refsrc) != 6:
        raise ValueError(f"{fn}: refsrc is (genome, gp, hm, jp, hr, ridx), "
                         f"got {len(refsrc)} parts")
    genome, gp, hm, jp, hr, ridx = refsrc
    Jw, G, nh = gp.shape[0], genome.shape[0], hr.shape[0]
    if G < L or nh == 0:
        raise ValueError(f"{fn}: needs a genome of at least L={L} bases "
                         f"({G}) and a host row ({nh})")
    if Jw == 0 or max(Jw, G, nh) >= 2**31:
        raise ValueError(f"{fn}: needs 0 < Jw={Jw} < 2**31 refbase rows")
    return ([("genome", genome, torch.uint8, (G,)), ("gp", gp, I32, (Jw,)),
             ("hm", hm, I32, (Jw,)), ("jp", jp, I32, (Jw,)),
             ("hr", hr, torch.uint8, (nh, L)), ("ridx", ridx, I32, (J,))],
            [None, ridx, genome, gp, hm, jp, hr], Jw, G, nh)


def vote_gathered(seq_src, qual_src, score_src, rows, row0, valid, job_len,
                  refbase, qtable=None, *, hi, mod, lo, base_score_req,
                  ratio_num, ratio_den, out_len=None, sparse=False,
                  refsrc=None):
    """csrc/vote.cu's gathered entry: the vote over members seq_src[rows[k,
    j]] (k < K) of each job j with the epilogue fused where the job is
    decided (rollback, nibble packing and, with sparse, the wire encoding;
    templates seq_src/qual_src[row0[j]]). Job j's refbase row is row j of
    refbase [J, L] or, with refbase None, the row refsrc names
    (`_ref_forms`), read by the kernel where it lies. Arguments and result
    as vote_gathered_plain's, equal byte for byte; every tensor on the
    matrices' device, which must be a CUDA device."""
    th = _thresholds(hi, mod, lo, base_score_req, ratio_num, ratio_den)
    dev = seq_src.device
    I32 = torch.int32
    K, J = rows.shape
    N, L = seq_src.shape
    ref_specs, ref_ptrs, Jw, G, nh = _ref_forms("vote_gathered", refbase,
                                                refsrc, J, L)
    _check("vote_gathered", [spec for spec in (
        ("seq_src", seq_src, torch.uint8, (N, L)),
        ("qual_src", qual_src, torch.uint8, (N, L)),
        ("score_src", score_src, torch.int8, (N, L)),
        ("rows", rows, I32, (K, J)),
        ("row0", row0, I32, (J,)),
        ("valid", valid, torch.uint8, (K, J)),
        ("job_len", job_len, I32, (J,)),
        *ref_specs,
        ("qtable", qtable, torch.uint8, (16,))) if spec[1] is not None], dev)
    _check_rows("vote_gathered", seq_src, qual_src, score_src, K, J)
    ol = _out_len("vote_gathered", out_len, L, sparse)
    if dev.type != "cuda":
        raise ValueError(f"vote_gathered: needs CUDA tensors, got {dev}")
    lib = build_library()
    pseq = torch.empty((J, ol // 2), dtype=torch.uint8, device=dev)
    new_qual = torch.empty((J, ol), dtype=torch.uint8, device=dev)
    diff = torch.empty(J, dtype=I32, device=dev)
    minc = torch.empty(J, dtype=I32, device=dev)
    enc = None
    wire = [None] * 9
    if sparse:
        enc = _sparse_fields(J, qtable is not None, dev)
        wire = [t.data_ptr() for t in enc]
        if J == 0:   # empty fields have no pointer: the kernel sees dense
            enc[8].zero_()
    _launch("gc_vote_epilogue", lib.gc_vote_epilogue,
            [t.data_ptr() if t is not None else None
             for t in (seq_src, qual_src, score_src, rows, row0, valid,
                       job_len, *ref_ptrs, qtable, pseq, new_qual, diff,
                       minc)] + wire,
            [K, J, L, N, ol, Jw, G, nh, th["hi"], th["mod"], th["lo"],
             th["bsr"], th["rnum"], th["rden"]], K, J, L, 4 * len(BINS) + 3,
            dev)
    global LAUNCHES, REFSRC_LAUNCHES
    LAUNCHES += 1
    if refsrc is not None:
        REFSRC_LAUNCHES += 1
    if not sparse:
        return pseq, new_qual, diff, minc
    return pseq, new_qual, diff, minc, enc


def _sparse_fields(J, with_qtable, dev):
    """The nine fields of one bucket's sparse encoding (see _epilogue_core),
    views of one device buffer: qv, qs, nr, sp, sb, nd u8, diff and minc
    int16 [J], bad int32 []."""
    qvw = SPARSE_RUNS // 2 if with_qtable else SPARSE_RUNS
    widths = (qvw, SPARSE_RUNS, 1, SPARSE_DIFFS, SPARSE_DIFFS // 2, 1)
    o16 = J * sum(widths) + (J * sum(widths)) % 2
    o32 = o16 + 4 * J + (-(o16 + 4 * J)) % 4
    buf = torch.empty(o32 + 4, dtype=torch.uint8, device=dev)
    out = []
    off = 0
    for w in widths:
        v = buf[off:off + J * w]
        out.append(v.view(J, w) if w > 1 else v)
        off += J * w
    out.append(buf[o16:o16 + 2 * J].view(torch.int16))
    out.append(buf[o16 + 2 * J:o16 + 4 * J].view(torch.int16))
    out.append(buf[o32:o32 + 4].view(torch.int32).reshape(()))
    return tuple(out)


def refbase_rows(refsrc, L):
    """The refbase rows [J, L] the gathered entry's source form names
    (`_ref_forms`), in plain PyTorch: refbase_combine over the sources,
    rows ridx clamped, as the JAX package gathers them."""
    genome, gp, hm, jp, hr, ridx = refsrc
    table = refbase_combine(genome, gp, hr, hm, jp, L)
    return table[_clamp_rows(ridx, table.shape[0])]


def vote_gathered_plain(seq_src, qual_src, score_src, rows, row0, valid,
                        job_len, refbase, qtable=None, *, hi, mod, lo,
                        base_score_req, ratio_num, ratio_den, out_len=None,
                        sparse=False, refsrc=None):
    """The gathered entry's plain twin, on any device: `vote_core_plain`
    over members seq_src[rows[k, j]] then `_epilogue_core` with templates
    seq_src/qual_src[row0[j]] (rows and row0 clamp to the matrix).
    seq_src/qual_src u8 [N, L], score_src i8 [N, L], rows i32 [K, J], row0
    i32 [J], valid u8 [K, J], job_len i32 [J], refbase u8 [J, L] (or None
    and refsrc, whose rows `refbase_rows` gives), qtable u8 [16] or None.
    Returns (pseq, new_qual, diff, minc[, enc])."""
    th = _thresholds(hi, mod, lo, base_score_req, ratio_num, ratio_den)
    if refsrc is not None:
        if refbase is not None:
            raise ValueError("vote_gathered_plain: refbase and refsrc both "
                             "given")
        refbase = refbase_rows(refsrc, seq_src.shape[1])
    cseq, cqual, chg, minc_pos = vote_core_plain(
        seq_src, qual_src, score_src, rows, valid, refbase, **th)
    r0 = _clamp_rows(row0, seq_src.shape[0])
    return _epilogue_core(cseq, cqual, chg, minc_pos, seq_src[r0],
                          qual_src[r0], job_len, out_len=out_len,
                          sparse=sparse, qtable=qtable)


def vote_core(seq_src, qual_src, score_src, rows, valid, refbase, *, hi, mod,
              lo, base_score_req, ratio_num, ratio_den):
    """csrc/vote.cu's vote alone over members seq_src[rows[k, j]] (k < K)
    of each job j: seq_src/qual_src u8 [N, L], score_src i8 [N, L], rows
    i32 [K, J], valid u8 [K, J], refbase u8 [J, L] (0 = no reference
    base). Returns (cand_seq, cand_qual, changed, minc_pos), each i32
    [J, L], equal to vote_core_plain's (what the JAX package's _pallas_core
    returns for seq_src[rows]). CUDA tensors only; no path of the port
    calls it (chip_smoke.py times it as the vote half of the composition
    vote_gathered replaced)."""
    th = _thresholds(hi, mod, lo, base_score_req, ratio_num, ratio_den)
    dev = seq_src.device
    K, J = rows.shape
    N, L = seq_src.shape
    _check("vote_core", (
        ("seq_src", seq_src, torch.uint8, (N, L)),
        ("qual_src", qual_src, torch.uint8, (N, L)),
        ("score_src", score_src, torch.int8, (N, L)),
        ("rows", rows, torch.int32, (K, J)),
        ("valid", valid, torch.uint8, (K, J)),
        ("refbase", refbase, torch.uint8, (J, L))), dev)
    _check_rows("vote_core", seq_src, qual_src, score_src, K, J)
    if dev.type != "cuda":
        raise ValueError(f"vote_core: needs CUDA tensors, got {dev}")
    lib = build_library()
    outs = [torch.empty((J, L), dtype=torch.int32, device=dev)
            for _ in range(4)]
    _launch("gc_vote", lib.gc_vote,
            [t.data_ptr() for t in (seq_src, qual_src, score_src, rows,
                                    valid, refbase, *outs)],
            [K, J, L, N, th["hi"], th["mod"], th["lo"], th["bsr"],
             th["rnum"], th["rden"]], K, J, L, 4 * len(BINS) + 3, dev)
    global VOTE_ONLY_LAUNCHES
    VOTE_ONLY_LAUNCHES += 1
    return tuple(outs)


def vote_full(seq_all, qual_all, score_all, rows, shifts, valid, job_len,
              refbase, *, hi, mod, lo, base_score_req, ratio_num, ratio_den):
    """The full-bins vote (kernels.fused_vote_kernel with full_bins=True)
    through csrc/vote.cu's Bins16 instantiation: members rows[j, k] with
    lenDiff shifts shifts[j, k], valid [J, K], job_len [J] (host arrays or
    tensors of any integer/bool type; they go to the matrices' device).
    Returns (new_seq u8 [J, L], new_qual u8 [J, L], diff i32 [J], minc
    i32 [J]). CUDA tensors only."""
    dev = seq_all.device
    if dev.type != "cuda":
        raise ValueError(f"vote_full: needs CUDA tensors, got {dev}")
    th = _thresholds(hi, mod, lo, base_score_req, ratio_num, ratio_den)
    I32 = torch.int32
    rows = to_device(rows, dev, I32).contiguous()
    shifts = to_device(shifts, dev, I32).contiguous()
    valid = to_device(valid, dev, torch.uint8).contiguous()
    job_len = to_device(job_len, dev, I32).contiguous()
    refbase = to_device(refbase, dev, torch.uint8).contiguous()
    J, K = rows.shape
    N, L = seq_all.shape
    _check("vote_full", (
        ("seq_all", seq_all, torch.uint8, (N, L)),
        ("qual_all", qual_all, torch.uint8, (N, L)),
        ("score_all", score_all, torch.int8, (N, L)),
        ("rows", rows, I32, (J, K)),
        ("shifts", shifts, I32, (J, K)),
        ("valid", valid, torch.uint8, (J, K)),
        ("job_len", job_len, I32, (J,)),
        ("refbase", refbase, torch.uint8, (J, L))), dev)
    _check_rows("vote_full", seq_all, qual_all, score_all, K, J)
    lib = build_library()
    new_seq = torch.empty((J, L), dtype=torch.uint8, device=dev)
    new_qual = torch.empty((J, L), dtype=torch.uint8, device=dev)
    diff = torch.empty(J, dtype=I32, device=dev)
    minc = torch.empty(J, dtype=I32, device=dev)
    _launch("gc_vote_full", lib.gc_vote_full,
            [t.data_ptr() for t in (seq_all, qual_all, score_all, rows,
                                    shifts, valid, job_len, refbase,
                                    new_seq, new_qual, diff, minc)],
            [K, J, L, N, th["hi"], th["mod"], th["lo"], th["bsr"],
             th["rnum"], th["rden"]], K, J, L, 4 * 16 + 3, dev)
    global FULL_LAUNCHES
    FULL_LAUNCHES += 1
    return new_seq, new_qual, diff, minc


def vote_core_plain(seq_src, qual_src, score_src, rows, valid, refbase, *,
                    hi, mod, lo, bsr, rnum, rden):
    """Plain-PyTorch twin of the kernel (port of pallas_vote._vote_block
    plus the sentinel pre-pass of _pallas_core), on any device."""
    K, J = rows.shape
    N, L = seq_src.shape
    dev = seq_src.device
    I32 = torch.int32
    r = rows.long().clamp(0, N - 1)
    v = valid.bool()
    rb = refbase.to(I32)
    has_ref = rb != 0
    zero = torch.zeros((J, L), dtype=I32, device=dev)
    B = len(BINS)
    counts = [zero] * B
    scores = [zero] * B
    quals = [zero] * B
    topq = [zero] * B
    total = zero
    ref_qual = zero
    high_ref = torch.zeros((J, L), dtype=torch.bool, device=dev)
    out_base = None
    for k in range(K):
        inv = ~v[k][:, None]
        s = seq_src[r[k]].to(I32).masked_fill(inv, SENTINEL)
        absent = s == SENTINEL
        q = qual_src[r[k]].to(I32).masked_fill(absent, 0)
        sc = score_src[r[k]].to(I32).masked_fill(absent, 0)
        if k == 0:
            out_base = s
        total = total + sc
        for bi, b in enumerate(BINS):
            m = (s == b).to(I32)
            counts[bi] = counts[bi] + m
            scores[bi] = scores[bi] + m * sc
            quals[bi] = quals[bi] + m * q
            topq[bi] = torch.maximum(topq[bi], m * q)
        refm = ((s == rb) & has_ref).to(I32)
        ref_qual = torch.maximum(ref_qual, refm * q)
        high_ref = high_ref | ((refm > 0) & (q >= hi))

    def full(x):
        return torch.full((J, L), x, dtype=I32, device=dev)

    # top election: lexmax of (score, qual, bin)
    top_base, top_score, top_qs = zero, full(NEG_INF), zero
    for bi, b in enumerate(BINS):
        better = (scores[bi] > top_score) | (
            (scores[bi] == top_score) & (quals[bi] >= top_qs))
        top_base = torch.where(better, full(b), top_base)
        top_score = torch.where(better, scores[bi], top_score)
        top_qs = torch.where(better, quals[bi], top_qs)
    vb = (top_score < 0) | ((top_score == 0) & (top_qs <= 0) & (top_base < 14))
    top_base = torch.where(vb, full(14), top_base)
    top_score = torch.where(vb, zero, top_score)
    top_qs = torch.where(vb, zero, top_qs)

    sec_base, sec_score, sec_qs = zero, full(NEG_INF), zero
    for bi, b in enumerate(BINS):
        better = (top_base != b) & ((scores[bi] > sec_score) | (
            (scores[bi] == sec_score) & (quals[bi] >= sec_qs)))
        sec_base = torch.where(better, full(b), sec_base)
        sec_score = torch.where(better, scores[bi], sec_score)
        sec_qs = torch.where(better, quals[bi], sec_qs)
    vidx = torch.where(top_base == 14, full(13), full(14))
    vb = (sec_score < 0) | ((sec_score == 0) & (sec_qs <= 0) & (sec_base < vidx))
    sec_base = torch.where(vb, vidx, sec_base)
    sec_score = torch.where(vb, zero, sec_score)

    def take_bin(arrs, idx):
        out = zero
        for bi, b in enumerate(BINS):
            out = torch.where(idx == b, arrs[bi], out)
        return out

    top_num = take_bin(counts, top_base)
    top_qual = take_bin(topq, top_base)
    sec_num = take_bin(counts, sec_base)
    sec_qsum = take_bin(quals, sec_base)

    accept_early = (sec_num == 0) & (top_score >= bsr) & (top_qual >= mod)
    need_ref = (sec_num == 0) & ~accept_early
    need_ref |= (sec_num == 1) & torch.where(
        sec_qsum <= lo, (top_num < 2) & (top_qual < hi),
        (top_num < 3) | (top_qual < hi))
    need_ref |= (sec_num > 1) & ((top_score * rden < total * rnum)
                                 | (top_qual < mod))
    need_ref |= (top_score < bsr) | (top_qual <= lo)
    do_ref = need_ref & has_ref & ~accept_early

    top_base2 = torch.where(do_ref & high_ref, rb, top_base)
    top_base2 = torch.where(do_ref & (top_qual < mod), rb, top_base2)
    top_qual2 = torch.where(do_ref & (top_base2 == rb), ref_qual, top_qual)

    changed = ~accept_early & (out_base != top_base2)
    cand_seq = torch.where(changed, top_base2, out_base)
    cand_qual = torch.where(accept_early, top_qual, top_qual2)
    inner = torch.where(out_base == rb, full(1),
                        torch.where(top_base2 == rb, full(-1), zero))
    minc_pos = torch.where(changed & has_ref, inner, zero)
    return cand_seq, cand_qual, changed.to(I32), minc_pos


def _first_index(mask):
    """Index of the first True per row, 0 where none (jnp.argmax of a 0/1
    row): the epilogue's masks have at most one True per row."""
    return torch.where(mask.any(dim=1), mask.to(torch.int32).argmax(dim=1),
                       torch.zeros((), dtype=torch.int64, device=mask.device))


def _epilogue_core(cseq, cqual, chg, minc_pos, seq0, qual0, job_len, *,
                   out_len=None, sparse=False, n_diffs=SPARSE_DIFFS,
                   n_runs=SPARSE_RUNS, qtable=None):
    """Per-read rollback + output packing (pallas_vote._epilogue_core).

    Returns (pseq, new_qual, diff, minc) — pseq 4-bit packed (BAM nibble
    layout, first base in the high nibble) — and with sparse=True also
    `enc`, the compact wire encoding: (qv, qs, nr, sp, sb, nd, diff i16,
    minc i16, bad i32) with run values as nibble-paired qtable indices
    when `qtable` (u8 [16]) is given. Requires out_len <= 256."""
    J, L = cseq.shape
    dev = cseq.device
    I32 = torch.int32
    U8 = torch.uint8
    pos_valid = (torch.arange(L, dtype=I32, device=dev)[None, :]
                 < job_len.to(I32)[:, None])
    tmpl_seq = seq0.to(I32)
    tmpl_qual = qual0.to(I32)
    zero = torch.zeros((), dtype=I32, device=dev)
    chg = torch.where(pos_valid, chg, zero)
    minc_pos = torch.where(pos_valid, minc_pos, zero)
    cseq = torch.where(pos_valid, cseq, tmpl_seq)
    cqual = torch.where(pos_valid, cqual, tmpl_qual)
    diff = chg.sum(dim=1, dtype=I32)
    minc = minc_pos.sum(dim=1, dtype=I32)
    rollback = (minc > 5)[:, None]
    new_seq = torch.where(rollback, tmpl_seq, cseq).to(U8)
    new_qual = torch.where(rollback, tmpl_qual, cqual).to(U8)
    ol = L if out_len is None else min(out_len, L)
    new_seq = new_seq[:, :ol]
    new_qual = new_qual[:, :ol]
    pseq = (new_seq[:, 0::2] << 4) | new_seq[:, 1::2]
    if not sparse:
        return pseq, new_qual, diff, minc

    # seq edits vs the template row (final rows: rollback and out-of-range
    # positions already hold template values and never edit)
    emask = (new_seq != seq0.to(U8)[:, :ol]).to(I32)
    nd = emask.sum(dim=1, dtype=I32)
    ranks = torch.cumsum(emask, dim=1, dtype=I32) * emask
    sp = []
    sb = []
    for d in range(1, n_diffs + 1):
        pos = _first_index(ranks == d)
        sp.append(pos)
        sb.append(new_seq.gather(1, pos[:, None])[:, 0])
    sp = torch.stack(sp, dim=1).to(U8)
    sb = torch.stack(sb, dim=1).to(U8)
    sbp = (sb[:, 0::2] << 4) | sb[:, 1::2]

    # qual runs
    q = new_qual.to(I32)
    b = torch.cat([torch.ones((J, 1), dtype=I32, device=dev),
                   (q[:, 1:] != q[:, :-1]).to(I32)], dim=1)
    rid = torch.cumsum(b, dim=1, dtype=I32) * b
    qs = []
    qv = []
    for r in range(1, n_runs + 1):
        pos = _first_index(rid == r)
        qs.append(pos)
        qv.append(q.gather(1, pos[:, None])[:, 0])
    qs = torch.stack(qs, dim=1).to(U8)
    qv = torch.stack(qv, dim=1).to(U8)
    nr = b.sum(dim=1, dtype=I32)
    nr8 = nr.clamp(max=255).to(U8)
    nd8 = nd.clamp(max=255).to(U8)

    if qtable is not None:
        qenc = torch.zeros(qv.shape, dtype=U8, device=dev)
        qdec = torch.zeros(qv.shape, dtype=U8, device=dev)
        for i in range(1, 16):
            hit = qv == qtable[i]
            qenc = torch.where(hit, torch.full_like(qenc, i), qenc)
            qdec = torch.where(hit, qtable[i], qdec)
        vrun = (torch.arange(n_runs, dtype=I32, device=dev)[None, :]
                < nr.clamp(max=n_runs)[:, None])
        bad = ((qdec != qv) & vrun).sum(dtype=I32)
        qvp = (qenc[:, 0::2] << 4) | qenc[:, 1::2]
        enc = (qvp, qs, nr8, sp, sbp, nd8, diff.to(torch.int16),
               minc.to(torch.int16), bad)
    else:
        enc = (qv, qs, nr8, sp, sbp, nd8, diff.to(torch.int16),
               minc.to(torch.int16), torch.zeros((), dtype=I32, device=dev))
    return pseq, new_qual, diff, minc, enc


def _bytes(t):
    """Little-endian byte view of a tensor, flattened (jax
    bitcast_convert_type to uint8, reshaped to 1-D)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def concat_sparse(encs):
    """One flat u8 wire buffer from per-bucket sparse encodings:
    [qv | qs | nr | sp | sb | nd | df | mc | bads]."""
    parts = [torch.cat([e[k] for e in encs], dim=0) if len(encs) > 1
             else encs[0][k] for k in range(8)]
    bads = torch.stack([e[8].reshape(()) for e in encs])
    qv, qs, nr, sp, sb, nd, df16, mc16 = parts
    return torch.cat([qv.reshape(-1), qs.reshape(-1), nr.reshape(-1),
                      sp.reshape(-1), sb.reshape(-1), nd.reshape(-1),
                      _bytes(df16), _bytes(mc16), _bytes(bads)])


def to_device(a, device, dtype=None):
    """Host array -> tensor on `device`. Unsigned 16/32-bit staging (which
    torch barely supports) widens to int32; values must fit."""
    if isinstance(a, torch.Tensor):
        t = a.to(device)
    else:
        a = np.asarray(a)
        if a.dtype in (np.uint16, np.uint32):
            a = a.astype(np.int32)
        elif a.dtype == np.bool_:
            a = a.astype(np.uint8)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _clamp_rows(idx, n):
    return idx.to(torch.int64).clamp(0, n - 1)


def wire_size(n_jobs, n_classes, qtable):
    """Bytes of the flat wire buffer [qv | qs | nr | sp | sb | nd | df | mc |
    bads] of n_jobs jobs in n_classes buckets (qv nibble-paired when a
    qtable is given)."""
    qvw = SPARSE_RUNS // 2 if qtable is not None else SPARSE_RUNS
    per_job = qvw + SPARSE_RUNS + 1 + SPARSE_DIFFS + SPARSE_DIFFS // 2 + 1 + 4
    return n_jobs * per_job + 4 * n_classes


def pallas_vote_window(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
                       qtable, class_args, *, classes, L, hi, mod, lo,
                       base_score_req, ratio_num, ratio_den, out_len):
    """EVERY fast vote bucket of one window (port of _pallas_window_all):
    refbase assembly (genome slice-gather + host rows), then per k-class
    (K, J) the vote of each job over its rows base..base+count-1, the
    rollback/sparse-encode epilogue, and the cross-class wire concat.
    class_args holds (base_row, counts, job_len, refbase row) per class.
    Returns (flat u8 wire buffer, [per-class (pseq, qual) dense
    fallbacks]): not the JAX function's refbase rows, which no caller of
    the port reads (the gathered vote reads the window's other rows from
    their sources). CUDA tensors launch the fused kernel
    (csrc/vote_window.cu, `vote_window`) once; CPU tensors run its plain
    twin `vote_window_plain`."""
    dev = seq_dev.device
    if dev.type == "cuda":
        fn = vote_window
    elif dev.type == "cpu":
        fn = vote_window_plain
    else:
        raise ValueError(f"pallas_vote_window: unsupported device {dev}")
    return fn(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
              class_args, classes=classes, L=L, hi=hi, mod=mod, lo=lo,
              base_score_req=base_score_req, ratio_num=ratio_num,
              ratio_den=ratio_den, out_len=out_len)


def vote_window_plain(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
                      qtable, class_args, *, classes, L, hi, mod, lo,
                      base_score_req, ratio_num, ratio_den, out_len):
    """The fused window kernel's plain twin, on any device: the refbase
    rows (`refbase_combine`), then per k-class `vote_core_plain` over rows
    base..base+K-1 masked by the member count and `_epilogue_core` with
    the sparse encoding, then `concat_sparse` (the composition the JAX
    package's _pallas_window_all makes). Arguments and result as
    pallas_vote_window's."""
    dev = seq_dev.device
    I32 = torch.int32
    refbase_dev = refbase_combine(
        to_device(genome, dev), to_device(gp, dev, I32), to_device(hr, dev),
        to_device(hm, dev, I32), to_device(jp, dev, I32), L)
    qtable = None if qtable is None else to_device(qtable, dev)
    th = _thresholds(hi, mod, lo, base_score_req, ratio_num, ratio_den)
    n_pad = seq_dev.shape[0]
    encs = []
    dense = []
    for ci, (K, _J) in enumerate(classes):
        base_row, counts, jl, ridx = (to_device(a, dev, I32) for a in
                                      class_args[4 * ci:4 * ci + 4])
        k_iota = torch.arange(K, dtype=I32, device=dev)[:, None]
        rows_t = base_row[None, :] + k_iota
        valid = (k_iota < counts[None, :]).to(torch.uint8)
        refbase = refbase_dev[_clamp_rows(ridx, refbase_dev.shape[0])]
        cseq, cqual, chg, minc_pos = vote_core_plain(
            seq_dev, qual_dev, score_dev, rows_t, valid, refbase, **th)
        br = _clamp_rows(base_row, n_pad)
        res = _epilogue_core(cseq, cqual, chg, minc_pos, seq_dev[br],
                             qual_dev[br], jl, out_len=out_len, sparse=True,
                             qtable=qtable)
        encs.append(res[4])
        dense.append((res[0], res[1]))
    return concat_sparse(encs), dense


def _host(a):
    return (a.cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a)).reshape(-1)


def _fits_i32(fn, name, a):
    if (a.size and a.dtype.itemsize >= 4 and a.dtype != np.int32
            and np.iinfo(a.dtype).max >= 2**31
            and (int(a.min()) < -2**31 or int(a.max()) >= 2**31)):
        raise ValueError(f"{fn}: {name} does not fit int32")


def window_job_table(class_args, classes, out=None):
    """The fused kernel's job table, int32 [6, Jt] (one row per field):
    per job of every class in order, base row, member count clipped to
    [0, K], job length, refbase row, class index and K. Filled into `out`
    when given."""
    cols = [[_host(a) for a in class_args[4 * ci:4 * ci + 4]]
            for ci in range(len(classes))]
    for ci, ((_K, J), c) in enumerate(zip(classes, cols)):
        if not all(len(a) == J for a in c):
            raise ValueError(f"vote_window: class {ci} needs {J} jobs in "
                             "each of its four arguments")
        for a in c:
            _fits_i32("vote_window", "a job field", a)
    Jt = sum(J for _K, J in classes)
    tab = np.empty((6, Jt), dtype=np.int32) if out is None else out
    off = 0
    for ci, ((K, J), (base_row, counts, jl, ridx)) in enumerate(
            zip(classes, cols)):
        t = tab[:, off:off + J]
        t[0] = base_row
        t[1] = counts
        np.clip(t[1], 0, K, out=t[1])
        t[2] = jl
        t[3] = ridx
        t[4] = ci
        t[5] = K
        off += J
    return tab


def window_upload_layout(Jt, Jw, qtable_bytes, hr_bytes):
    """Byte offsets of the parts of the window kernel's one upload, and its
    size: the job table int32 [6, Jt], the refbase sources gp, hm, jp
    int32 [Jw], the qual table (16 bytes, or none), then at the next
    multiple of 16 bytes (the kernel copies them 16 bytes at a time) the
    host rows u8 [nh, L] (none when the kernel reads them from the
    device)."""
    lay = {"jobs": 0, "gp": 24 * Jt}
    lay["hm"] = lay["gp"] + 4 * Jw
    lay["jp"] = lay["hm"] + 4 * Jw
    lay["qtable"] = lay["jp"] + 4 * Jw
    lay["hr"] = -(-(lay["qtable"] + qtable_bytes) // 16) * 16
    lay["size"] = lay["hr"] + hr_bytes
    return lay


def window_upload(class_args, classes, gp, hm, jp, qtable=None, hr=None,
                  alloc=None):
    """The window kernel's one upload, u8, in window_upload_layout's
    order: window_job_table, the refbase sources gp, hm, jp of every job
    of the window as int32, the qual table and the host rows when given.
    Returns (buffer, layout); the buffer comes from alloc(size) when
    given."""
    gp, hm, jp = _host(gp), _host(hm), _host(jp)
    Jw = len(gp)
    if len(hm) != Jw or len(jp) != Jw:
        raise ValueError(f"vote_window: gp, hm and jp need one entry per job "
                         f"of the window, got {Jw}, {len(hm)}, {len(jp)}")
    for name, a in (("gp", gp), ("hm", hm), ("jp", jp)):
        _fits_i32("vote_window", name, a)
    Jt = sum(J for _K, J in classes)
    qt = None if qtable is None else _host(qtable).astype(np.uint8)
    if qt is not None and qt.shape != (16,):
        raise ValueError(f"vote_window: qtable has {qt.size} entries, not 16")
    hrb = None if hr is None else np.ascontiguousarray(hr, dtype=np.uint8)
    lay = window_upload_layout(Jt, Jw, 0 if qt is None else 16,
                               0 if hrb is None else hrb.nbytes)
    buf = (np.empty(lay["size"], dtype=np.uint8) if alloc is None
           else alloc(lay["size"]))
    ints = buf[:lay["qtable"]].view(np.int32)
    window_job_table(class_args, classes, out=ints[:6 * Jt].reshape(6, Jt))
    ints[6 * Jt:6 * Jt + Jw] = gp
    ints[6 * Jt + Jw:6 * Jt + 2 * Jw] = hm
    ints[6 * Jt + 2 * Jw:] = jp
    qt_end = lay["qtable"] + (0 if qt is None else 16)
    if qt is not None:
        buf[lay["qtable"]:qt_end] = qt
    buf[qt_end:lay["hr"]] = 0  # the padding before the host rows
    if hrb is not None:
        buf[lay["hr"]:lay["size"]] = hrb.reshape(-1)
    return buf, lay


def vote_window(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
                class_args, *, classes, L, hi, mod, lo, base_score_req,
                ratio_num, ratio_den, out_len):
    """Launch csrc/vote_window.cu over every class of one window, the
    refbase rows built in the kernel: arguments and result as
    pallas_vote_window's, equal byte for byte to vote_window_plain's. The
    job table, gp, hm, jp, a host qual table and host rows go up in one
    pinned copy (window_upload); a qtable or hr already on the device is
    read where it lies. CUDA tensors only."""
    dev = seq_dev.device
    N, Lm = seq_dev.shape
    if Lm != L:
        raise ValueError(f"vote_window: matrices are {Lm} wide, L={L}")
    if L % 16 or not 0 < L <= 256:
        raise ValueError(f"vote_window: L={L} must be a multiple of 16 in "
                         "(0, 256] (a thread per position, 16-byte row "
                         "copies)")
    qt_dev = qtable if isinstance(qtable, torch.Tensor) else None
    hr_dev = hr if isinstance(hr, torch.Tensor) else None
    hr_host = None if hr_dev is not None else np.asarray(hr)
    G = genome.shape[0]
    nh = (hr_dev if hr_dev is not None else hr_host).shape[0]
    _check("vote_window", [
        spec for spec in (
            ("seq_dev", seq_dev, torch.uint8, (N, L)),
            ("qual_dev", qual_dev, torch.uint8, (N, L)),
            ("score_dev", score_dev, torch.int8, (N, L)),
            ("genome", genome, torch.uint8, (G,)),
            ("qtable", qt_dev, torch.uint8, (16,)),
            ("hr", hr_dev, torch.uint8, (nh, L))) if spec[1] is not None],
        dev)
    if hr_host is not None and hr_host.shape != (nh, L):
        raise ValueError(f"vote_window: hr has shape {hr_host.shape}, "
                         f"expected ({nh}, {L})")
    for name, t in (("seq_dev", seq_dev), ("qual_dev", qual_dev),
                    ("score_dev", score_dev), ("hr", hr_dev)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"vote_window: {name} is not 16-byte aligned")
    ol = _out_len("vote_window", out_len, L, True)
    Jw = len(_host(gp))
    if len(_host(hm)) != Jw or len(_host(jp)) != Jw:
        raise ValueError("vote_window: gp, hm and jp need one entry per job "
                         "of the window")
    Jt = sum(J for _K, J in classes)
    if N == 0 or Jw == 0 or Jt == 0 or nh == 0:
        raise ValueError("vote_window: needs at least one source row, job, "
                         "window job and host row")
    if G < L:
        raise ValueError(f"vote_window: the genome ({G}) is shorter than "
                         f"L={L}")
    if max(N, Jw, Jt, G, nh) >= 2**31:
        raise ValueError("vote_window: a dimension does not fit the "
                         "kernel's int")
    if dev.type != "cuda":
        raise ValueError(f"vote_window: needs CUDA tensors, got {dev}")
    nb = len(classes)
    qt_host = None if qtable is None or qt_dev is not None else qtable
    up, lay = pinned_upload(lambda alloc: window_upload(
        class_args, classes, gp, hm, jp, qt_host, hr_host, alloc=alloc),
        dev)
    at = {k: up.data_ptr() + v for k, v in lay.items()}
    qt_ptr = (qt_dev.data_ptr() if qt_dev is not None
              else None if qt_host is None else at["qtable"])
    hr_ptr = hr_dev.data_ptr() if hr_dev is not None else at["hr"]
    flat = torch.empty(wire_size(Jt, nb, qtable), dtype=torch.uint8,
                       device=dev)
    pseq = torch.empty((Jt, ol // 2), dtype=torch.uint8, device=dev)
    qual = torch.empty((Jt, ol), dtype=torch.uint8, device=dev)
    scratch = torch.empty(nb + 2, dtype=torch.int32, device=dev)
    lib = build_library()
    th = _thresholds(hi, mod, lo, base_score_req, ratio_num, ratio_den)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with tracing.span("launch.gc_vote_window", rows=N, J=Jt, L=L,
                          classes=nb):
            err = lib.gc_vote_window(
                seq_dev.data_ptr(), qual_dev.data_ptr(),
                score_dev.data_ptr(), genome.data_ptr(), at["gp"], at["hm"],
                at["jp"], hr_ptr, at["jobs"], qt_ptr, flat.data_ptr(),
                pseq.data_ptr(), qual.data_ptr(), scratch.data_ptr(), N, L,
                G, nh, Jw, Jt, nb, ol, th["hi"], th["mod"], th["lo"],
                th["bsr"], th["rnum"], th["rden"], stream)
    if err != 0:
        raise RuntimeError(f"gc_vote_window launch failed: cudaError_t {err}")
    global WINDOW_LAUNCHES
    WINDOW_LAUNCHES += 1
    dense = []
    off = 0
    for _K, J in classes:
        dense.append((pseq[off:off + J], qual[off:off + J]))
        off += J
    return flat, dense


def pinned_upload(fill, dev):
    """One upload without a host sync: fill(alloc) writes a pinned host
    buffer that alloc(size) hands it and returns (buffer, layout); its
    first layout["size"] bytes go to `dev` in one non-blocking copy.
    Returns (device buffer, layout)."""
    staged = []

    def alloc(size):
        staged.append(torch.empty(size, dtype=torch.uint8, pin_memory=True))
        return staged[0].numpy()

    _buf, lay = fill(alloc)
    return staged[0][:lay["size"]].to(dev, non_blocking=True), lay


def window_stage():
    """Members of a job that csrc/vote_window.cu stages with the job (its
    kStage); a job of more votes the rest in chunks of as many."""
    return build_library().gc_vote_window_stage()


def window_grid(L, Jt, device):
    """The persistent grid csrc/vote_window.cu launches for Jt jobs at
    width L on `device` (a CUDA device): the blocks resident at once on
    the card, at most Jt."""
    lib = build_library()
    with torch.cuda.device(device):
        n = lib.gc_vote_window_grid(int(L), int(Jt))
    if n <= 0:
        raise RuntimeError(f"gc_vote_window_grid({L}, {Jt}) failed")
    return n


def refbase_combine(genome, gpos, host_rows, host_map, jl, L):
    """Refbase rows: a genome slice at gpos for contiguous-M jobs
    (host_map < 0; zero at and beyond jl), else host_rows[host_map]
    (the JAX engine._refbase_combine_fn). The slice start goes as in
    jax.lax.dynamic_slice: a negative start counts once from the genome's
    end, then clamps to [0, len(genome) - L]."""
    dev = genome.device
    I32 = torch.int32
    hm = host_map.to(I32)
    G = genome.shape[0]
    start = gpos.to(torch.int64)
    start = torch.where(start < 0, start + G, start).clamp(0, max(G - L, 0))
    g = genome[start[:, None] + torch.arange(L, device=dev)[None, :]]
    keep = torch.arange(L, dtype=I32, device=dev)[None, :] < jl.to(I32)[:, None]
    g = torch.where(keep, g, torch.zeros((), dtype=g.dtype, device=dev))
    h = host_rows[_clamp_rows(hm, host_rows.shape[0])]
    return torch.where((hm < 0)[:, None], g, h)


def refbase_upload(gp, hr, hm, jp, alloc=None):
    """A window's refbase sources in one buffer, u8: gp, hm, jp of every
    job as int32, then at the next multiple of 16 bytes the host rows u8
    [nh, L] (window_upload_layout with no job table or qual table).
    Returns (buffer, layout); the buffer comes from
    alloc(size) when given."""
    gp, hm, jp = _host(gp), _host(hm), _host(jp)
    J = len(gp)
    if len(hm) != J or len(jp) != J:
        raise ValueError(f"refbase: gp, hm and jp need one entry per job, "
                         f"got {J}, {len(hm)}, {len(jp)}")
    for name, a in (("gp", gp), ("hm", hm), ("jp", jp)):
        _fits_i32("refbase", name, a)
    hrb = np.ascontiguousarray(hr, dtype=np.uint8)
    lay = window_upload_layout(0, J, 0, hrb.nbytes)
    buf = (np.empty(lay["size"], dtype=np.uint8) if alloc is None
           else alloc(lay["size"]))
    ints = buf[:lay["qtable"]].view(np.int32)
    ints[:J] = gp
    ints[J:2 * J] = hm
    ints[2 * J:] = jp
    buf[lay["qtable"]:lay["hr"]] = 0
    buf[lay["hr"]:lay["size"]] = hrb.reshape(-1)
    return buf, lay


def window_refsrc(genome, gp, hm, jp, hr):
    """A window's refbase sources on the genome's device, for every
    gathered bucket of the window to read (`refsrc=` with each bucket's
    ridx appended): (genome, gp, hm, jp int32 [Jw], hr u8 [nh, L]). On a
    CUDA device the host arrays go up in one pinned copy
    (refbase_upload); the views share its buffer, which lives as long as
    any of them."""
    dev = genome.device
    if dev.type != "cuda":
        I32 = torch.int32
        return (genome, to_device(gp, dev, I32), to_device(hm, dev, I32),
                to_device(jp, dev, I32), to_device(hr, dev, torch.uint8))
    hr = np.asarray(hr)
    up, lay = pinned_upload(lambda alloc: refbase_upload(gp, hr, hm, jp,
                                                         alloc=alloc), dev)
    Jw = len(_host(gp))
    ints = up[:lay["qtable"]].view(torch.int32)
    return (genome, ints[:Jw], ints[Jw:2 * Jw], ints[2 * Jw:],
            up[lay["hr"]:lay["size"]].view(hr.shape))


def pack_parts(arrays, alloc=None):
    """Host arrays in one u8 buffer, each at a multiple of 16 bytes in its
    own dtype. Returns (buffer, offsets); the buffer comes from
    alloc(size) when given."""
    offs = np.cumsum([0] + [-(-a.nbytes // 16) * 16 for a in arrays])
    size = max(int(offs[-1]), 16)
    buf = np.zeros(size, dtype=np.uint8) if alloc is None else alloc(size)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    return buf, [int(o) for o in offs[:-1]]


def pinned_parts(arrays, dev):
    """Host arrays to `dev` (a CUDA device) in one pinned non-blocking
    copy (pack_parts); returns a contiguous tensor view of each on
    `dev`."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs = []

    def fill(alloc):
        buf, o = pack_parts(arrays, alloc)
        offs.extend(o)
        return buf, {"size": len(buf)}

    up, _ = pinned_upload(fill, dev)
    return [up[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .reshape(a.shape) for a, o in zip(arrays, offs)]


def _host_as(fn, a, dt):
    """Host array a as numpy dtype dt; values cast to int32 must fit."""
    a = np.asarray(a)
    if a.dtype != dt:
        if np.dtype(dt).itemsize == 4:
            _fits_i32(fn, "an array", a)
        a = a.astype(dt)
    return a


def _gathered(dev):
    """The gathered entry for tensors on `dev`: the kernel on a CUDA
    device, its plain twin on the CPU."""
    if dev.type == "cuda":
        return vote_gathered
    if dev.type == "cpu":
        return vote_gathered_plain
    raise ValueError(f"gathered vote: unsupported device {dev}")


def pallas_vote_gathered(seq_dev, qual_dev, score_dev, rows_t, row0, valid,
                         job_len, refbase, qtable=None, *, hi, mod, lo,
                         base_score_req, ratio_num, ratio_den, out_len=None,
                         sparse=False, refsrc=None):
    """Vote over member rows rows_t [K, J] of the device matrices plus the
    epilogue with template rows row0 [J] (port of the JAX function of the
    same name). Job j's refbase row is row j of refbase [J, L] or, with
    refbase None, the row refsrc names (vote_gathered's source form; its
    ridx may be a host array). On a CUDA device the host arrays among
    rows_t, row0, valid, job_len, refbase, ridx and qtable go up in one
    pinned copy (`pinned_parts`, values cast to int32 must fit); tensors
    are read where they lie. Returns (pseq, new_qual, diff, minc[,
    enc])."""
    dev = seq_dev.device
    parts = [(rows_t, np.int32), (row0, np.int32), (valid, np.uint8),
             (job_len, np.int32), (refbase, np.uint8),
             (None if refsrc is None else refsrc[-1], np.int32),
             (qtable, np.uint8)]
    host = [i for i, (a, _) in enumerate(parts)
            if a is not None and not isinstance(a, torch.Tensor)]
    if dev.type == "cuda" and host:
        up = pinned_parts([_host_as("pallas_vote_gathered", *parts[i])
                           for i in host], dev)
        for i, t in zip(host, up):
            parts[i] = (t, parts[i][1])
    rows_t, row0, valid, job_len, refbase, ridx, qtable = (
        None if a is None else to_device(
            a, dev, torch.int32 if dt == np.int32 else torch.uint8)
        .contiguous() for a, dt in parts)
    if refsrc is not None:
        refsrc = (*refsrc[:-1], ridx)
    return _gathered(dev)(
        seq_dev, qual_dev, score_dev, rows_t, row0, valid, job_len, refbase,
        qtable, hi=hi, mod=mod, lo=lo, base_score_req=base_score_req,
        ratio_num=ratio_num, ratio_den=ratio_den, out_len=out_len,
        sparse=sparse, refsrc=refsrc)


def pallas_vote(seq, qual, score, valid, job_len, refbase, *, hi, mod, lo,
                base_score_req, ratio_num, ratio_den, out_len=None,
                sparse=False, device=None, refsrc=None):
    """Vote over members the host has gathered: seq/qual u8 [K, S, L],
    score i8 [K, S, L], valid [K, S], job_len [S], refbase u8 [S, L] or,
    with refbase None, the rows refsrc names (vote_gathered's source form,
    its sources on `device`, its ridx a host array or a tensor); host
    arrays go to `device`. The gathered entry reads the [K*S, L] view with
    rows k*S + j and templates row j (member 0's rows). Returns (pseq,
    new_qual, diff, minc[, enc])."""
    dev = device if device is not None else (
        seq.device if isinstance(seq, torch.Tensor) else torch.device("cpu"))
    seq = to_device(seq, dev, torch.uint8)
    qual = to_device(qual, dev, torch.uint8)
    score = to_device(score, dev, torch.int8)
    K, S, L = seq.shape
    rows = torch.arange(K * S, dtype=torch.int32, device=dev).view(K, S)
    if refbase is not None:
        refbase = to_device(refbase, dev, torch.uint8).contiguous()
    if refsrc is not None:
        refsrc = (*refsrc[:-1],
                  to_device(refsrc[-1], dev, torch.int32).contiguous())
    return _gathered(dev)(
        seq.reshape(K * S, L).contiguous(), qual.reshape(K * S, L).contiguous(),
        score.reshape(K * S, L).contiguous(), rows, rows[0],
        to_device(valid, dev, torch.uint8).contiguous(),
        to_device(job_len, dev, torch.int32).contiguous(), refbase, None,
        hi=hi, mod=mod, lo=lo, base_score_req=base_score_req,
        ratio_num=ratio_num, ratio_den=ratio_den, out_len=out_len,
        sparse=sparse, refsrc=refsrc)
