"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero with no `ok` line):
  0 environment: torch/CUDA/nvcc versions, whether triton imports, the
    card's name and power limit, and the port's native I/O core built from
    gencore_tpu_torch/csrc/gcio.cpp with its DEFLATE codec (libdeflate or
    zlib); the run fails here, with the reason, when the core does not
    build or load (the CLI's main path, streaming, needs it);
  1 build: the CUDA kernels from gencore_tpu_torch/csrc (one nvcc per
    source, in parallel, sm_90a), registers and spills per kernel;
  2 each kernel against its plain twin on the same inputs, exact (0
    mismatches):
      2a gc_vote_epilogue (csrc/vote.cu's gathered entry: Bins6 with the
         epilogue fused) against vote_gathered_plain (vote_core_plain +
         _epilogue_core) at J=4096, L=160, N=40960 for every k-class K in
         {4, 16, 32, 64, 128, 256}, dense, sparse and sparse with a qual
         table;
      2b gc_vote_window (csrc/vote_window.cu, the refbase rows read in the
         kernel from the genome and host rows) against vote_window_plain
         at the same shapes, member counts 0..K, job lengths <= L, out_len
         = L and 136, with and without a qual table;
      2c gc_vote_epilogue at the deep-pile shapes J in {8, 32, 128}, K in
         {512, 2048, 4096}, L=160 (disjoint member groups, K/2 < count <=
         K), with the CTAs per job (split) each launch used, against the
         composition it replaced (csrc/vote.cu's vote alone, gc_vote, then
         the plain _epilogue_core): both device and call times; and each
         job's refbase row read by index where it lies (the window's
         sources) beside the rows given ready-made, equal and timed in
         turns;
      2d gc_vote_full (csrc/vote.cu, Bins16: kernels.fused_vote_kernel on
         CUDA tensors) against kernels.fused_vote_plain on the card, all 16
         nt16 codes, lenDiff shifts, job lengths <= L;
      2e gc_upload_score (csrc/upload_score.cu: the window's upload
         rebuild and overlap scoring, K4-K6, one copy up and one launch)
         against its plain twin engine._upload_score_plain on the card at
         the deep panel's window shape (n = 48,000 rows, w = 150, L = 160,
         u16 mate rows) and at 72,000 rows (u32 mate rows) for all 128
         combinations of its other seven static flags, on staging with the
         program's edges (workloads.upload_staging), then mate pairs it
         must not take as pairs at both widths (pair_edges), then timed
         with the deep panel's flags (at 72,000 rows also with
         no_overlap); K11's counterpart, gc_vote_epilogue reading each
         job's refbase row where it lies (genome starts negative, past the
         end and in range, host-row indices and ridx clamped), in the
         source and rows forms against refbase_combine, the row gather and
         the plain vote, at J = 1, 28 and 16,064 jobs;
      2f the dense staging route's kernels (csrc/upload_dense.cu; both
         read their inputs in aligned words, 16 positions of a row per
         task, 16-byte stores): gc_upload_unpack (K12, staging bytes
         decoded through shared tables) against
         engine._upload_unpack_plain for all 6 seq and qual mode pairs at
         the deep panel's single-shot shape (239,499 rows, w = 152, L =
         160) and a 2x300 window (48,000 rows, w = 304, L = 320), lengths
         0, odd, w and past w, and untimed at w = 8, 34 and 152 (rows
         off a word) with 1,001 rows; gc_score_map (K5, a warp per batch
         of rows, a mate pair taken once by the warp of its lower row,
         four positions per word) against kernels.score_map_packed_plain
         (packed, 48,000 rows) and kernels.score_map_plain (int32
         geometry, 239,499 rows at L = 160 and 48,000 at L = 320) with
         negative cmp_len, mate starts on both sides, ties, self, clamped
         and third-row mates, pairs whose geometry does not mirror, pairs
         with one row unscored, pairs across a warp's and a block's batch
         and unscored rows, then untimed with tiers that wrap the int8
         cast, reach outside the byte range or are unordered;
    with each kernel's device time (vote_window: torch.profiler; vote.cu:
    CUDA events around each call with the stream kept busy ahead of them)
    and its wrapper's time per call, its plain version's time per call on
    the card (CUDA events,
    in turns plain, kernel, kernel, plain) where the kernels line needs
    it, its bound and its share of the bound;
  3 a ~3k-read workload (duplex UMIs, deep clusters, lenDiff-shifted right
    reads) through the port's CLI on cuda, against the scalar oracle:
    records and report stats equal, and both kernels launched (the window
    path and the gathered paths); its shifted call of the most jobs
    (pallas_vote) replayed against its plain twin and timed;
  3b the full-bins panel (workloads.full_bins_panel: IUPAC codes, duplex
    UMIs, shifted right reads) through the CLI on cuda, against the port's
    --oracle and the golden digests; the 16-bin launches counted beside
    the 6-bin ones;
  4 the 240k-read deep panel (workloads.deep_panel) through the port's CLI
    on cuda with its default path selection, which must be the streaming
    path (parallel/streaming.run_streaming on the native core), against
    the golden digests that the JAX package made
    (gencore_tpu_torch/testdata): wall seconds, reads/s, the codec, the
    stage sums, each window launch's (K, J, sum of member counts) per class
    and whether it had a qual nibble table;
  phases 4, 4b, 4c, 4d, 7, 7b and 9 run with the plain versions made to
    raise on CUDA tensors where a hand kernel stands for them
    (_no_plain_on_card): the plain _epilogue_core inside vote.py's Pallas
    counterparts (pallas_vote_window, pallas_vote_gathered, pallas_vote),
    and anywhere the plain upload rebuild and upload-and-score program,
    the plain dense unpack, both plain score maps and refbase_combine;
  phases 7 and 7b also count the engine's gathered votes handed
    ready-made refbase rows (a refbase gather or a standalone assembly
    ahead of them): there must be none;
    each phase also needs the counterparts and (where its windows stage
    sparse) the upload-and-score program to have run;
  4b the same input with `--shards 4 --checkpoint_dir D`, then again after
    one shard's files were deleted from D (resume): both equal to the
    golden digests, the second run recomputing exactly that shard;
  4c the same input through the in-memory window pipeline
    (parallel/pipeline.run_pipelined, `--windows 5` under
    GENCORE_NO_STREAM, the CLI's path for what it does not stream): once
    with the native core, each window written as it retires, and once as
    on a machine without the core (pure-Python codec, windows merged into
    one payload); both equal to the golden digests, window votes launched;
  4d the same input single-shot (`--windows 1`): one window of 239,499
    rows whose staging stays dense (past the u16 row limit), against the
    golden digests; the dense unpack and score map must launch;
  5 the deep panel's largest window launch, replayed: the fused kernel
    against its twin (exact) and timed against the plain composition on
    the card, with its bound, its (job, position) pairs and the
    persistent grid it launched (blocks, and blocks per SM); and the
    deep panel's largest deferred upload (recorded in phase 4) through
    gc_upload_score against its twin (exact), timed the same way, with
    the host's time per call;
  6 device busy time, kernel and memcpy counts of one run each of the
    deep panel (streaming and single-shot), the ultra-deep pile and the
    long-read panel (torch.profiler) before, with the compositions the
    port's kernels replaced put back for those runs only (the plain
    upload-and-score program after 16 copies up; the plain refbase
    assembly and row gather ahead of each gathered vote; the dense route's
    plain unpack after four and its plain score maps), and after; all but the single-shot run must
    take the streaming path; a run whose trace lost kernel records is
    profiled again, up to three times;
  7 the ultra-deep pile (workloads.ultradeep: 40 loci x 1,500 pairs, UMI
    grouping off) through the CLI on cuda, which must take the streaming
    path, against its golden digests, its 3 gathered votes reading each
    job's refbase row from the window's sources: wall seconds and
    reads/s, then a recorded run with each gathered vote launch's (K, J),
    split, device time in the source and rows forms and share of its
    bound, the launch of the most jobs also against its plain twin;
  7b the long_amplicon panel (workloads.long_amplicon: 2x300 reads, so
    every window stages dense and votes at L = 320 through the gathered
    entry) through the CLI's default streaming path against its golden
    digests: the dense unpack and score map and 6 gathered votes at L =
    320 reading the window's refbase sources must launch; wall seconds
    and reads/s, then the run's largest unpack, score map and gathered
    vote replayed against their twins and timed;
  8 parallel/mesh.py with one rank on the card (a torch.distributed NCCL
    group of one process, and a one-device mesh): sharded_consensus_step
    (the Bins16 kernel through kernels.consensus_kernel) against the plain
    vote on the CPU, and stats_psum against the numpy sum, exact;
  9 the case matrix of gencore_tpu_torch/tools/golden_compare.py: 15 CLI
    cases over the JAX CLI's option surface (MI tags, duplex, -s/-c,
    --no_duplex, -x, a BED, no FASTA, -a and the qual tiers, SAM in and
    out, --quit_after_contig, and real duplex merges with and without -x;
    read length 100, so L = 128), 41 runs, each on every
    route the CLI allows (its own choice, --stream, --windows 3), against
    the golden digests that the JAX CLI made
    (gencore_tpu_torch/testdata/cases), with each run's vote launches
    (counters zeroed just before it; every run must launch one); then both
    kernels at L = 128 against their plain twins, exact: defaults_noumi's
    window launch replayed, and the gathered entry on inputs of its shape;
 10 entry.entry() on the card against kernels.consensus_plain (exact), and
    entry.dryrun_multichip(1) on cuda:0: 1-device records, stats_psum
    against the host merge, the window plan and the busy-time rebalance,
    and two host processes pinned to cores 0 and 1 on the one card, with
    the plain versions made to raise as in phase 4 and each window's
    upload staging (mode, rows, dense table) recorded: every sparse window
    (162,257 rows, u32 mate rows) must launch upload_score once; then
    one more pinned host of both shards through host_steps, which times
    each step of multihost.run_host on its own (torch import, first CUDA
    call, library loads, FASTA load, read_all, shard keys, and per shard
    the engine construction, eng.run and the files) and gives each
    shard window's upload staging and upload_score launches (one for a
    sparse window), on its own line;
 11 tools/measure_rss.py at scale 1 and 2 (the deep panel of 40,000 and
    80,000 fragments): peak resident set (VmHWM, or where the kernel does
    not report it, VmRSS sampled every 10 ms), tracemalloc peak, glibc's
    heap at the end, the pinned host pool (torch.cuda.host_memory_stats,
    where this torch has it) and CUDA max allocated / reserved of the
    in-memory window pipeline and of the streaming path, each in a fresh
    process, whose outputs must hold the same records; and the streaming
    path's growth from scale 1 to 2, traced and untraced;
 12 the port's native core with zlib under ThreadSanitizer: its exerciser
    csrc/test_gcio.cpp built with -fsanitize=thread and run; a race or a
    nonzero exit fails the run, a compiler that refuses the TSan build is
    reported on its own line.
Then the kernels line (with each kernel's launches summed over phase 9)
and the card line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Bounds: the bytes each input is read once and each output written once
(the dense score map's seq only where its rows' overlaps need it) over
3.35 TB/s, and ~10 int32 operations per (valid member, position) of
a vote (16 per (row, position) of the upload-and-score program, 8 of the
dense unpack, 12 of the dense score map) over 16.7 T op/s (132 SMs x 64
INT32 lanes x 1.98 GHz); the larger one binds.

JAX and the JAX package are blocked for the whole run: nothing here may
import them.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

sys.modules["jax"] = None          # the port must run without JAX
sys.modules["jaxlib"] = None
sys.modules["gencore_tpu"] = None  # ... and without the JAX package

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
KW = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4, ratio_den=5)
K_CLASSES = (4, 16, 32, 64, 128, 256)
J_PHASE2, L_PHASE2, N_PHASE2 = 4096, 160, 40960
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_MEMBER_POS = 10
DEEP_SHAPES = tuple((J, K) for J in (8, 32, 128) for K in (512, 2048, 4096))
DEEP_TIMED = (32, 2048)   # the ultradeep run's gathered buckets: K=2048
# kernels timed by their profiler records: their wrappers also copy the
# kernel's inputs up, which CUDA events around a call would count
PROFILED = ("vote_window_kernel", "upload_score_kernel")
# the deep panel's windows: ~48k read rows of 150 bases padded to L = 160
N_UPLOAD, W_UPLOAD, L_UPLOAD = 48_000, 150, 160
N_UPLOAD32 = 72_000     # past 65,536 rows: u32 mate rows
# (J, K, L) of phase 2e's buckets whose refbase rows the gathered entry
# reads by index: one job at L = 32, the ultra-deep run's 28 jobs, the
# deep panel's largest window of 16,064 jobs
REFSRC_SHAPES = ((1, 4, 32), (28, 512, 160), (16_064, 4, 160))
# gathered launches per run, all reading their refbase rows from the
# window's sources: the ultra-deep pile (phase 7), the long_amplicon
# panel (7b)
ULTRADEEP_GATHERED, LONG_AMPLICON_GATHERED = 3, 6
SCORE_KW = dict(hi=30, mod=20, lo=15, s_hi=12, s_mod=8, s_lo=6, s_bad=4)
# integer operations csrc/upload_score.cu does per (row, position): the
# decode, the qual's source, the mask, the overlap test, the mate compare,
# the tier chain and the selects (a scored row's mate rebuilt again)
OPS_PER_UPLOAD_POS = 16
# the dense staging route's shapes (rows, w, L): the deep panel single-shot
# (--windows 1: one window of 239,499 rows of 150 bases) and a 2x300
# streaming window; and the modes each times with (seq, qual: the deep
# panel's three qual values ship 2-bit, unbinned MiSeq quals raw)
DENSE_SHAPES = ((239_499, 152, 160), (48_000, 304, 320))
DENSE_TIMED_MODES = (("2bit", "2bit"), ("2bit", "raw"))
# the score map's timed shapes (rows, L, packed geometry)
DENSE_SCORE_SHAPES = ((48_000, 160, True), (239_499, 160, False),
                      (48_000, 320, False))
# 2f's edges, untimed: unpack widths whose 2-bit rows are not 4-byte
# multiples at a row count that is no multiple of a block's tasks; tiers
# that wrap the int8 cast, reach outside the byte range or are unordered,
# at row counts that are no multiple of a warp's or a block's batch
DENSE_EDGE_WIDTHS = (8, 34, 152)
DENSE_EDGE_ROWS = 1_001
SCORE_EDGE_TIERS = (
    dict(hi=30, mod=20, lo=15, s_hi=126, s_mod=-127, s_lo=127, s_bad=-3),
    dict(hi=300, mod=0, lo=-4, s_hi=9, s_mod=1000, s_lo=-200, s_bad=5),
    dict(hi=15, mod=30, lo=20, s_hi=3, s_mod=-9, s_lo=7, s_bad=255))
SCORE_EDGE_SHAPES = ((5_003, 160, True), (5_003, 160, False),
                     (4_999, 320, False))
# integer operations per (row, position): csrc/upload_dense.cu's unpack
# (the length test, the decode, the table, two byte inserts) and score map
# (the overlap test, the mate's column, the compare, the tier chain, the
# selects, two byte inserts)
OPS_PER_UNPACK_POS = 8
OPS_PER_SCORE_POS = 12


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(n_bytes, n_ops):
    """(bound ms, what binds) for work that moves n_bytes and does n_ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_env(torch):
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.io import native
    nvcc = vote._find_nvcc()
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                        timeout=60).stdout.strip().splitlines()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError as e:
        triton_v = f"no ({e})"
    t0 = time.perf_counter()
    if native.get_lib() is None:
        fail(0, "the native I/O core did not build or load, so the CLI's "
                f"main path (streaming) cannot run: {native.why_not()}")
    t_core = time.perf_counter() - t0
    card = nvidia_smi_line()
    emit({"phase": 0, "name": "environment", "ok": True,
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nv[-1] if nv else "",
          "triton": triton_v, "card": card,
          "device_count": torch.cuda.device_count(),
          "native_io": True, "codec": native.codec(),
          "native_io_library": os.path.relpath(native.get_lib()._name, REPO),
          "native_io_build_s": t_core,
          "cli_path": "streaming (file >= 1 MiB)"})
    return card


def phase_build():
    from gencore_tpu_torch.core import vote
    t0 = time.perf_counter()
    vote.build_library()
    dt = time.perf_counter() - t0
    kernels = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'(.*?)Used (\d+) "
                         r"registers", vote.BUILD_LOG, re.S):
        fn = m.group(1)
        out = re.search(r"OutE(\d)E", fn)   # vote.cu's Out: 0 the vote alone
        name = ("vote_window" if "vote_window" in fn else
                "upload_score" if "upload_score" in fn else
                "upload_unpack" if "upload_unpack" in fn else
                ("score_map (packed)" if "ILb1E" in fn else "score_map")
                if "score_map" in fn else
                "vote (16 bins)" if "Bins16" in fn else
                "vote alone" if out and out.group(1) == "0" else "vote")
        form = re.search(r"RefE(\d)E", fn)  # vote.cu's refbase form
        if form and form.group(1) != "0":
            name += " (sources)"
        if "decide_kernel" in fn:   # vote.cu's second pass (split > 1)
            name += ", decide"
        spill = re.search(r"(\d+) bytes spill stores", m.group(2))
        kernels[name] = {"registers": int(m.group(3)),
                         "spill_store_bytes": int(spill.group(1)) if spill
                         else None}
    emit({"phase": 1, "name": "build", "ok": True, "seconds": dt,
          "library": os.path.relpath(vote.library_path(), REPO),
          "kernels": kernels})


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(torch, fn, reps, name):
    """Per call of fn, from a torch.profiler trace of `reps` calls: (device
    ms of the kernels whose name holds `name`, each launched once per
    call; device ms of all kernels; kernels launched). A kernel counts its
    median duration (times its launches per call, for the totals): the
    profiler now and then delivers a session's kernel records late, so a
    trace may lack them or hold the previous session's too. A trace
    without a record of `name` is taken again, up to three times."""
    from statistics import median

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        path = os.path.join(WORK, "timing_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        by_name = {}
        for e in events:
            if e.get("cat") == "kernel" and "dur" in e:
                by_name.setdefault(e.get("name", ""), []).append(
                    float(e["dur"]))
        if any(name in k for k in by_name):
            break
    per_call = {k: median(d) * max(1, round(len(d) / reps)) / 1e3
                for k, d in by_name.items()}
    n = sum(max(1, round(len(d) / reps)) for d in by_name.values())
    return (sum(median(d) / 1e3 for k, d in by_name.items() if name in k),
            sum(per_call.values()), n)


def _kernel_ms(torch, fn, reps=5):
    """Device ms per call of fn: CUDA events right around each call while
    a torch.cuda._sleep ahead of them keeps the stream busy, so the host's
    launch overhead stays off the clock; the median over reps. (The
    profiler drops kernel records now and then: a vote.cu launch of
    0.3 ms went missing from three traces in a row.)"""
    from statistics import median
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return median(times)


def _timings(torch, plain, kern, name, plain_reps, kern_reps,
             profile_plain=True):
    """The kernel's device time (profiler), and the wall time per call of
    the kernel's wrapper and of the plain version (CUDA events, in turns
    plain, kernel, kernel, plain), with the plain version's device time
    and kernel count per call unless profile_plain is False (a plain
    version of tens of thousands of launches per call overflows the
    profiler's buffers)."""
    if name in PROFILED:   # the kernel alone, without its wrapper's copy
        ms = _device_ms(torch, kern, kern_reps, name)[0]
    else:
        ms = _kernel_ms(torch, kern, kern_reps)
    if not ms > 0:
        fail(2, f"no {name} kernel in the profiler's trace")
    p1, k1, k2, p2 = (_time_ms(torch, f, r) for f, r in (
        (plain, plain_reps), (kern, kern_reps), (kern, kern_reps),
        (plain, plain_reps)))
    res = {"ms": ms, "call_ms": (k1 + k2) / 2, "call_ms_runs": [k1, k2],
           "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2]}
    if profile_plain:
        _, plain_dev, plain_kernels = _device_ms(torch, plain, plain_reps,
                                                 name)
        res.update(plain_device_ms=plain_dev,
                   plain_kernels_per_call=plain_kernels)
    return res


def _matrices(np, rng, L, N):
    """seq/qual u8 and score i8 [N, L]: =ACGTN codes with stored sentinels,
    seven qual values, negative scores."""
    codes = np.array([0, 1, 2, 4, 8, 15, 255], dtype=np.uint8)
    seq = codes[rng.choice(7, size=(N, L),
                           p=[.04, .23, .23, .23, .23, .03, .01])]
    qual = rng.choice(np.array([2, 12, 18, 25, 30, 36, 41], np.uint8),
                      size=(N, L))
    score = rng.integers(-4, 13, size=(N, L)).astype(np.int8)
    return seq, qual, score


def _vote_inputs(np, K, J, L, N, seed):
    """Inputs shaped as the window program gave them to csrc/vote.cu:
    rows base..base+K-1 (clamped), counts per job (0 = padded job with
    every member absent, template included), negative scores, stored
    sentinels, and jobs without a reference base."""
    rng = np.random.default_rng(seed)
    seq, qual, score = _matrices(np, rng, L, N)
    base = rng.integers(0, N, size=J)
    rows = np.clip(base[None, :] + np.arange(K)[:, None], 0, N - 1)
    counts = rng.integers(1, K + 1, size=J)
    counts[::9] = 0
    valid = (np.arange(K)[:, None] < counts[None, :])
    valid &= rng.random((K, J)) < 0.97
    refbase = np.array([0, 1, 2, 4, 8], np.uint8)[
        rng.integers(0, 5, size=(J, L))]
    refbase[::4] = 0
    return (seq, qual, score, rows.astype(np.int32),
            valid.astype(np.uint8), refbase)


GATHERED_MODES = ("dense", "sparse", "sparse_qtable")


def _qtable(np):
    """A qual table for _matrices' values: 41 escapes, 30 listed twice
    (the last matching index wins)."""
    qt = np.zeros(16, dtype=np.uint8)
    qt[1:7] = [2, 12, 18, 25, 30, 36]
    qt[9] = 30
    return qt


def _gathered_args(np, arrs, seed, mode):
    """The gathered entry's arguments from a vote's members (seq, qual,
    score, rows, valid, refbase), as engine._vote_pallas gives them:
    templates row0 = rows[0], job lengths <= L (most L), the qual table in
    mode sparse_qtable; and its keywords (out_len = L, sparse)."""
    seq, qual, score, rows, valid, refbase = arrs
    rng = np.random.default_rng(seed)
    L = seq.shape[1]
    job_len = rng.integers(1, L + 1, size=rows.shape[1]).astype(np.int32)
    job_len[::3] = L
    qtable = _qtable(np) if mode == "sparse_qtable" else None
    return ((seq, qual, score, rows, np.ascontiguousarray(rows[0]), valid,
             job_len, refbase, qtable),
            dict(out_len=L, sparse=mode != "dense", **KW))


def _gathered_bound(np, args, kw):
    """(bytes, int ops) of the gathered entry on these inputs: each valid
    member row read once (3 B per position), each template row not among
    them once (2 B), the row indices, flags, template rows, job lengths,
    refbase and qual table once; written once the dense rows (1.5 B per
    output position), diff and minc (8 B per job) and, sparse, the wire
    fields (27 or 22 B per job) and the escape count; 10 ops per (valid
    member, position)."""
    seq, _q, _s, rows, row0, valid, _jl, _rb, qtable = args
    N, L = seq.shape
    K, J = rows.shape
    v = valid.astype(bool)
    members = np.unique(np.clip(rows[v], 0, N - 1))
    tmpl = np.setdiff1d(np.unique(np.clip(row0, 0, N - 1)), members)
    ol = min(kw["out_len"] or L, L)
    n_bytes = (len(members) * 3 * L + len(tmpl) * 2 * L + K * J * 5 + 8 * J
               + J * L + (16 if qtable is not None else 0)
               + J * (ol // 2 + ol) + 8 * J)
    if kw["sparse"]:
        n_bytes += J * ((5 if qtable is not None else 10) + 22) + 4
    return n_bytes, OPS_PER_MEMBER_POS * int(v.sum()) * L


def _compare(got, want):
    """(mismatching elements, max abs difference) of two output tuples of
    the gathered entry (the sparse fields flattened in)."""
    def flat(r):
        return [t.cpu() for t in (*r[:4], *(r[4] if len(r) > 4 else ()))]
    g, w = flat(got), flat(want)
    if len(g) != len(w) or any(a.shape != b.shape or a.dtype != b.dtype
                               for a, b in zip(g, w)):
        return -1, -1
    mism = sum(int((a != b).sum()) for a, b in zip(g, w))
    err = max((int((a.long() - b.long()).abs().max()) for a, b in zip(g, w)
               if a.numel()), default=0)
    return mism, err


def phase_vote_kernel(torch, np):
    """2a: the gathered entry against its plain twin (on the card) for
    every k-class and mode; timed as the engine runs it, sparse with a
    qual table, against the plain composition."""
    from gencore_tpu_torch.core import vote
    dev = torch.device("cuda", 0)
    J, L, N = J_PHASE2, L_PHASE2, N_PHASE2
    per_k = []
    worst = 0
    for K in K_CLASSES:
        arrs = _vote_inputs(np, K, J, L, N, K)
        modes = {}
        for mode in GATHERED_MODES:
            args, kw = _gathered_args(np, arrs, K, mode)
            gpu = [None if a is None else torch.from_numpy(a).to(dev)
                   for a in args]
            got = vote.vote_gathered(*gpu, **kw)
            want = vote.vote_gathered_plain(*gpu, **kw)
            torch.cuda.synchronize(dev)
            mism, err = _compare(got, want)
            worst = max(worst, err)
            modes[mode] = {"mismatches": mism, "max_abs_err": err}
            if mism:
                fail("2a", f"gathered kernel != plain twin at K={K}, {mode}: "
                           f"{mism} mismatches")
        t = _timings(torch, lambda: vote.vote_gathered_plain(*gpu, **kw),
                     lambda: vote.vote_gathered(*gpu, **kw), "vote_kernel",
                     2, 20)
        n_bytes, n_ops = _gathered_bound(np, args, kw)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_k.append({"K": K, "J": J, "L": L, "N": N, "modes": modes,
                      "max_abs_err": max(m["max_abs_err"]
                                         for m in modes.values()),
                      "timed_mode": "sparse_qtable", **t, "bytes": n_bytes,
                      "int_ops": n_ops, "bound_ms": b_ms, "bound_by": b_by,
                      "share_of_bound": b_ms / t["ms"]})
        del gpu, got, want
    emit({"phase": "2a", "name": "gc_vote_epilogue vs vote_gathered_plain",
          "ok": True, "tolerance": "exact (0 mismatches)",
          "plain": "vote_gathered_plain on CUDA tensors (vote_core_plain + "
                   "_epilogue_core)", "per_k": per_k})
    n_bytes = sum(p["bytes"] for p in per_k)
    n_ops = sum(p["int_ops"] for p in per_k)
    b_ms, b_by = bound(n_bytes, n_ops)
    return {"ms": sum(p["ms"] for p in per_k),
            "call_ms": sum(p["call_ms"] for p in per_k),
            "plain_ms": sum(p["plain_ms"] for p in per_k),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": worst}


def _pile_inputs(np, K, J, L, seed):
    """A bucket of deep piles as the gathered path gives it to
    csrc/vote.cu: J jobs whose members are disjoint groups of rows (job j
    owns rows j*K..j*K+count-1), K/2 < count <= K as in a next-pow2
    bucket, absent members pointing at a dummy row, stored sentinels,
    negative scores, jobs without a reference base."""
    rng = np.random.default_rng(seed)
    N = J * K + 1
    seq, qual, score = _matrices(np, rng, L, N)
    counts = rng.integers(K // 2 + 1, K + 1, size=J)
    k = np.arange(K)[:, None]
    valid = k < counts[None, :]
    rows = np.where(valid, np.arange(J)[None, :] * K + k, N - 1)
    refbase = np.array([0, 1, 2, 4, 8], np.uint8)[
        rng.integers(0, 5, size=(J, L))]
    refbase[::4] = 0
    return (seq, qual, score, rows.astype(np.int32),
            valid.astype(np.uint8), refbase)


def _composition(vote, args, kw):
    """What the gathered entry replaced: csrc/vote.cu's vote alone, then
    the plain epilogue on its four int32 arrays (templates gathered by
    row0)."""
    seq, qual, score, rows, row0, valid, job_len, refbase, qtable = args
    th = {k: v for k, v in kw.items() if k not in ("out_len", "sparse")}
    cseq, cqual, chg, minc_pos = vote.vote_core(seq, qual, score, rows, valid,
                                                refbase, **th)
    r0 = row0.long().clamp(0, seq.shape[0] - 1)
    return vote._epilogue_core(cseq, cqual, chg, minc_pos, seq[r0], qual[r0],
                               job_len, out_len=kw["out_len"],
                               sparse=kw["sparse"], qtable=qtable)


def phase_deep_piles(torch, np):
    """2c: the gathered entry at the deep-pile shapes against its plain
    twin (on the card), with its device and call times, bound and share,
    beside the composition it replaced (the vote alone, then the plain
    epilogue): that composition's call time and its vote kernel's device
    time. Sparse with a qual table, as the engine runs a deep pile. Each
    job's refbase row is named by index in a window of 2J + 5 rows
    (_with_refsrc): the gathered entry also reads it where it lies, from
    the window's sources, equal to the rows form (the rows given
    ready-made) and timed beside it in turns (rows, sources, sources,
    rows)."""
    from gencore_tpu_torch.core import vote
    dev = torch.device("cuda", 0)
    per_shape = []
    for J, K in DEEP_SHAPES:
        arrs = _pile_inputs(np, K, J, L_PHASE2, J + K)
        args, kw = _gathered_args(np, arrs, J + K, "sparse_qtable")
        gpu, src = _with_refsrc(torch, np, args, J + K + 2, dev, 2 * J + 5)
        forms = _forms(vote, gpu, src, kw)

        def kern():
            return vote.vote_gathered(*gpu, **kw)

        def before():
            return _composition(vote, gpu, kw)

        got = kern()
        want = vote.vote_gathered_plain(*gpu, **kw)
        old = before()
        torch.cuda.synchronize(dev)
        mism, err = _compare(got, want)
        mism_old, _ = _compare(old, want)
        mism_src = _compare(forms["sources"](), want)[0]
        if mism or mism_old or mism_src:
            fail("2c", f"gathered kernel ({mism}; source form {mism_src}) "
                       f"or the composition before ({mism_old}) != plain "
                       f"twin at J={J}, K={K}")
        if (J, K) == DEEP_TIMED:   # the ultradeep run's shape: with plain
            t = _timings(torch, lambda: vote.vote_gathered_plain(*gpu, **kw),
                         kern, "vote_kernel", 1, 5, profile_plain=False)
        else:
            t = {"ms": _kernel_ms(torch, kern),
                 "call_ms": _time_ms(torch, kern, 5)}
        th = {k: v for k, v in kw.items() if k not in ("out_len", "sparse")}
        vote_args = [gpu[i] for i in (0, 1, 2, 3, 5, 7)]
        # in turns: before, after, after, before
        b1, k1, k2, b2 = (_time_ms(torch, f, 5)
                          for f in (before, kern, kern, before))
        turns = _turns(torch, forms)
        t.update(forms_ms_in_turns={f: sum(v) / 2 for f, v in turns.items()},
                 forms_ms_turns=turns,
                 vote_only_ms=_kernel_ms(
                     torch, lambda: vote.vote_core(*vote_args, **th)),
                 composition_call_ms=(b1 + b2) / 2,
                 composition_call_ms_runs=[b1, b2],
                 call_ms_in_turns=[k1, k2])
        ms = t["ms"]
        n_bytes, n_ops = _gathered_bound(np, args, kw)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_shape.append({"J": J, "K": K, "L": L_PHASE2, "N": len(arrs[0]),
                          "split": vote.split_size(K, J),
                          "members": int(arrs[4].sum()), "mismatches": mism,
                          "max_abs_err": err, **t,
                          "bytes": n_bytes, "int_ops": n_ops,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "share_of_bound": b_ms / ms})
        del gpu, got, want, old, forms, src
    emit({"phase": "2c", "name": "gc_vote_epilogue at deep-pile shapes vs "
                                 "vote_gathered_plain, beside the vote alone "
                                 "+ plain epilogue", "ok": True,
          "tolerance": "exact (0 mismatches)", "per_shape": per_shape})
    return per_shape


FULL_SHAPES = ((4096, 16), (4096, 64), (1024, 256), (32, 2048), (8, 4096))


def _full_inputs(np, K, J, L, seed):
    """A full-bins bucket as the engine gives it to csrc/vote.cu's Bins16
    instantiation: [J, K] members in disjoint groups of rows, all 16 nt16
    codes and stored sentinels, lenDiff shifts on a third of the members,
    K/2 < count <= K, job lengths <= L, jobs without a reference base."""
    rng = np.random.default_rng(seed)
    N = J * K + 1
    seq = rng.integers(0, 16, size=(N, L)).astype(np.uint8)
    seq[rng.random((N, L)) < 0.01] = 255
    qual = rng.choice(np.array([2, 12, 18, 25, 30, 36, 41], np.uint8),
                      size=(N, L))
    score = rng.integers(-4, 13, size=(N, L)).astype(np.int8)
    counts = rng.integers(K // 2 + 1, K + 1, size=J)
    k = np.arange(K)[None, :]
    valid = k < counts[:, None]
    rows = np.where(valid, np.arange(J)[:, None] * K + k, N - 1)
    shifts = np.where(rng.random((J, K)) < 0.3,
                      rng.integers(0, 20, size=(J, K)), 0)
    job_len = rng.integers(L // 2, L + 1, size=J)
    job_len[::3] = L
    refbase = np.array([0, 1, 2, 4, 8, 5, 12], np.uint8)[
        rng.integers(0, 7, size=(J, L))]
    refbase[::4] = 0
    return (seq, qual, score, rows.astype(np.int32), shifts.astype(np.int32),
            valid.astype(np.uint8), job_len.astype(np.int32), refbase)


def _full_bound(np, rows, valid, job_len, K, J, L):
    """(bytes, int ops) of a full-bins vote: each valid member row read
    once, rows, shifts, flags, job lengths and refbase read once, new_seq,
    new_qual, diff and minc written once; 10 ops per valid member and
    position below the job length."""
    v = valid.astype(bool)
    n_rows = len(np.unique(rows[v]))
    n_bytes = (n_rows * 3 * L + J * K * 9 + J * 4 + J * L + 2 * J * L
               + 8 * J)
    n_ops = OPS_PER_MEMBER_POS * int((v.sum(axis=1)
                                      * np.minimum(job_len, L)).sum())
    return n_bytes, n_ops


def phase_full_kernel(torch, np):
    """2d: csrc/vote.cu's Bins16 instantiation (kernels.fused_vote_kernel
    on CUDA tensors) against its plain twin kernels.fused_vote_plain on the
    card, exact, with device time, bound and share."""
    from gencore_tpu_torch.core import kernels, vote
    dev = torch.device("cuda", 0)
    per_shape = []
    for J, K in FULL_SHAPES:
        arrs = _full_inputs(np, K, J, L_PHASE2, 3 * J + K)
        gpu = [torch.from_numpy(a).to(dev) for a in arrs]

        def kern():
            return kernels.fused_vote_kernel(*gpu, **KW, full_bins=True)

        def plain():
            return kernels.fused_vote_plain(*gpu, **KW, full_bins=True)

        got = kern()
        want = plain()
        torch.cuda.synchronize(dev)
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        if mism:
            fail("2d", f"Bins16 kernel != twin at J={J}, K={K}: {mism} "
                       "mismatches")
        t = _timings(torch, plain, kern, "Bins16", 1, 5)
        n_bytes, n_ops = _full_bound(np, arrs[3], arrs[5], arrs[6], K, J,
                                     L_PHASE2)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_shape.append({"J": J, "K": K, "L": L_PHASE2,
                          "split": vote.split_size(K, J),
                          "members": int(arrs[5].sum()), "mismatches": mism,
                          "max_abs_err": err, **t, "bytes": n_bytes,
                          "int_ops": n_ops, "bound_ms": b_ms,
                          "bound_by": b_by, "share_of_bound": b_ms / t["ms"]})
        del gpu, got, want
        torch.cuda.empty_cache()
    emit({"phase": "2d", "name": "gc_vote_full (Bins16) vs "
                                 "kernels.fused_vote_plain", "ok": True,
          "tolerance": "exact (0 mismatches)", "per_shape": per_shape})
    return per_shape


def _window_class_args(np, rng, K, J, N, Jw, L):
    """One k-class as the engine stages it: base rows (some running past
    the matrix: they clamp), uint8 member counts 0..K, job lengths <= L,
    refbase rows."""
    kmax = min(K, 255)
    base = rng.integers(0, N, size=J).astype(np.uint16 if N <= 65536
                                              else np.uint32)
    base[:8] = N - 3
    counts = rng.integers(0, kmax + 1, size=J).astype(np.uint8)
    counts[::9] = 0
    counts[1::10] = kmax
    jl = rng.integers(0, L + 1, size=J).astype(np.uint16)
    jl[::3] = L
    ridx = rng.integers(0, Jw, size=J).astype(np.uint16)
    return [base, counts, jl, ridx]


def _refbase_sources(np, rng, Jw, L, G=1 << 20, nh=64):
    """A window's refbase sources as engine._refbase_host_args makes them:
    the NT16 genome padded by 4096, genome starts (a few past the end:
    they clamp), host rows (row 0 all zero) for 1 in 8 jobs, int16 host
    map, uint16 job lengths <= L."""
    genome = np.pad(np.array([1, 2, 4, 8], np.uint8)[
        rng.integers(0, 4, size=G)], (0, 4096))
    gp = rng.integers(0, G, size=Jw).astype(np.int32)
    gp[:4] = len(genome) - L + 5
    hr = np.array([0, 1, 2, 4, 8], np.uint8)[rng.integers(0, 5, size=(nh, L))]
    hr[0] = 0
    hm = np.where(rng.random(Jw) < 0.875, -1,
                  rng.integers(0, nh, size=Jw)).astype(np.int16)
    jp = rng.integers(0, L + 1, size=Jw).astype(np.uint16)
    jp[::3] = L
    return genome, gp, hr, hm, jp


def _window_bound(np, class_args, classes, N, L, srcs, out_len, qtable):
    """(bytes, int ops) the fused window kernel must move and do on these
    inputs: every member row and template row of an empty job read once,
    the refbase sources (gp, hm, jp; each genome slice up to its length,
    each host row used) of the rows its jobs name once, the job table and
    qual table once; the wire buffer and the dense fallback written once;
    10 ops per (member, position)."""
    from gencore_tpu_torch.core import vote
    gp, hr, hm, jp = (np.asarray(a) for a in srcs[1:])
    Jw = len(gp)
    named = np.zeros(Jw, dtype=bool)
    member = np.zeros(N, dtype=bool)
    tmpl = np.zeros(N, dtype=bool)
    n_members = 0
    Jt = 0
    for ci, (K, J) in enumerate(classes):
        base, counts, _jl, ridx = (np.asarray(a).astype(np.int64) for a in
                                   class_args[4 * ci:4 * ci + 4])
        named[np.clip(ridx, 0, Jw - 1)] = True
        cnt = np.clip(counts, 0, K)
        n_members += int(cnt.sum())
        off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        member[np.clip(np.repeat(base, cnt) + off, 0, N - 1)] = True
        tmpl[np.clip(base[cnt == 0], 0, N - 1)] = True
        Jt += J
    ol = min(out_len, L)
    hm, jp = hm.astype(np.int64)[named], jp.astype(np.int64)[named]
    ref_bytes = (12 * int(named.sum()) + int(np.minimum(jp[hm < 0], L).sum())
                 + len(np.unique(np.clip(hm[hm >= 0], 0, len(hr) - 1))) * L)
    n_bytes = (int(member.sum()) * 3 * L + int((tmpl & ~member).sum()) * 2 * L
               + ref_bytes + 24 * Jt
               + (16 if qtable is not None else 0)
               + vote.wire_size(Jt, len(classes), qtable) + Jt * (ol // 2 + ol))
    return n_bytes, OPS_PER_MEMBER_POS * n_members * L, n_members


def _compare_window(got, want):
    """(mismatching bytes, max abs difference) of two window results: the
    flat wire buffer first and the dense fallbacks last (flat, dense), or
    (flat, refbase_dev, dense) from a checkout whose window kernel also
    wrote the refbase rows."""
    pairs = [(got[0], want[0])] + [
        (g, w) for gd, wd in zip(got[-1], want[-1]) for g, w in zip(gd, wd)]
    mism = 0
    err = 0
    for g, w in pairs:
        g = g.cpu()
        w = w.cpu()
        if g.shape != w.shape:
            return -1, -1
        mism += int((g != w).sum())
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return mism, err


def phase_window_kernel(torch, np):
    from gencore_tpu_torch.core import vote
    dev = torch.device("cuda", 0)
    J, L, N = J_PHASE2, L_PHASE2, N_PHASE2
    Jw = J + J // 4            # the window's other jobs: refbase rows only
    per_k = []
    worst = 0
    for K in K_CLASSES:
        rng = np.random.default_rng(1000 + K)
        seq, qual, score = _matrices(np, rng, L, N)
        srcs = _refbase_sources(np, rng, Jw, L)
        class_args = _window_class_args(np, rng, K, J, N, Jw, L)
        classes = ((K, J),)
        qtable = _qtable(np)
        cpu = [torch.from_numpy(a) for a in (seq, qual, score, srcs[0])]
        gpu = [t.to(dev) for t in cpu]
        variants = []
        for out_len in (L, 136):
            for qt in (None, qtable):
                kw = dict(classes=classes, L=L, out_len=out_len, **KW)
                got = vote.vote_window(*gpu, *srcs[1:], qt, class_args, **kw)
                torch.cuda.synchronize(dev)
                want = vote.vote_window_plain(*cpu, *srcs[1:], qt, class_args,
                                              **kw)
                mism, err = _compare_window(got, want)
                worst = max(worst, err)
                variants.append({"out_len": out_len,
                                 "qtable": qt is not None,
                                 "mismatches": mism, "max_abs_err": err})
                if mism:
                    fail("2b", f"vote_window kernel != twin at K={K}, "
                               f"out_len={out_len}, qtable={qt is not None}:"
                               f" {mism} mismatching bytes")
        # timed as the main path runs it: out_len = L, with a qual table
        kw = dict(classes=classes, L=L, out_len=L, **KW)
        t = _timings(
            torch,
            lambda: vote.vote_window_plain(*gpu, *srcs[1:], qtable,
                                           class_args, **kw),
            lambda: vote.vote_window(*gpu, *srcs[1:], qtable, class_args,
                                     **kw),
            "vote_window_kernel", 2, 20)
        n_bytes, n_ops, n_members = _window_bound(
            np, class_args, classes, N, L, srcs, L, qtable)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_k.append({"K": K, "J": J, "Jw": Jw, "L": L, "N": N,
                      "sum_counts": n_members, "variants": variants, **t,
                      "bytes": n_bytes, "int_ops": n_ops, "bound_ms": b_ms,
                      "bound_by": b_by, "share_of_bound": b_ms / t["ms"]})
    emit({"phase": "2b", "name": "gc_vote_window vs vote_window_plain",
          "ok": True, "tolerance": "exact (0 mismatching bytes)",
          "plain": "vote_window_plain on CUDA tensors (refbase_combine, "
                   "vote_core_plain, _epilogue_core and concat_sparse)",
          "per_k": per_k})
    return worst


def _host_ms(torch, fn, reps):
    """The host's own time per call of fn, from the call to its return,
    each call made on an idle stream: the median over reps (ms)."""
    from statistics import median
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return median(times)


def _upload_static(w, L, flags):
    from gencore_tpu_torch.core.kernels import UPLOAD_FLAGS
    f = dict(zip(UPLOAD_FLAGS, flags))
    return (w, L, f["mode2"], f["has_sedit"], f["has_qdense"], f["has_qedit"],
            f["const_lens"], *SCORE_KW.values(), f["has_genome"],
            f["no_overlap"], f.get("mate32", False))


def _upload_calls(torch, static, staging, dev):
    """(kernel, plain) callables of one upload-and-score program on the
    card: the kernel through engine._upload_score_fn with the host
    staging (one copy up), the plain twin with each array copied up
    alone, as the port ran it before (the genome already on the card)."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core.vote import to_device
    fn = engine._upload_score_fn(*static)
    args = list(staging)
    if not isinstance(args[14], torch.Tensor):
        args[14] = torch.as_tensor(args[14]).to(dev)

    def kern():
        return fn(*args, device=dev)

    def plain():
        return engine._upload_score_plain(*static)(
            *[a if isinstance(a, torch.Tensor) else to_device(a, dev)
              for a in args])
    return kern, plain


def _upload_bound(np, static, staging):
    """(bytes, int ops) of one upload-and-score program on these inputs:
    the staging's upload read once (kernels.upload_score_layout's bytes),
    each genome slot's w bases read once, seq, qual and score [n, L]
    written once; OPS_PER_UPLOAD_POS per (row, position)."""
    from gencore_tpu_torch.core import kernels
    w, L = static[0], static[1]
    host = [*staging[:14], staging[15]]
    n = len(staging[1])
    genome_bytes = len(staging[15]) * w if static[14] else 0
    n_bytes = (kernels.upload_score_layout(host)["size"] + genome_bytes
               + 3 * n * L)
    return n_bytes, OPS_PER_UPLOAD_POS * n * L


def _upload_compare(got, want):
    """(mismatching bytes, max abs difference) of two (seq, qual, score)."""
    mism = err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            return -1, -1
        g, w = g.cpu(), w.cpu()
        mism += int((g != w).sum())
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return mism, err


def _upload_timed(torch, np, static, staging, dev, phase):
    """The kernel against its twin on the card (exact), then its device
    ms (profiler), host ms per call, wall ms per call in turns with the
    plain version, bound and share."""
    kern, plain = _upload_calls(torch, static, staging, dev)
    mism, err = _upload_compare(kern(), plain())
    torch.cuda.synchronize()
    if mism:
        fail(phase, f"upload_score kernel != twin at {static}: {mism} "
                    "mismatching bytes")
    t = _timings(torch, plain, kern, "upload_score_kernel", 5, 20)
    t["host_ms"] = _host_ms(torch, kern, 50)
    n_bytes, n_ops = _upload_bound(np, static, staging)
    b_ms, b_by = bound(n_bytes, n_ops)
    return {"n": len(staging[1]), "w": static[0], "L": static[1],
            "mismatches": mism, "max_abs_err": err, **t, "bytes": n_bytes,
            "int_ops": n_ops, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / t["ms"]}


def _refbase_inputs(np, rng, J, L, G0=1 << 20, nh=64):
    """Refbase sources as engine._refbase_host_args makes them, with
    starts that count from the genome's end or run past it and host-row
    indices past the rows (they clamp)."""
    genome, gp, hr, hm, jp = _refbase_sources(np, rng, J, L, G0, nh)
    G = len(genome)
    gp[4::7] = -rng.integers(1, G, size=len(gp[4::7]))
    gp[5::11] = -3 * G
    hm[6::13] = nh + 2
    return genome, gp, hr, hm, jp


def _refsrc_bytes(np, ref, L):
    """Bytes the gathered entry reads to find its jobs' refbase rows by
    index, each source read once: ridx (4 B per job) and, per distinct row
    named, its 12 bytes of sources and its bases (a genome slice up to its
    length, a host row once per host row)."""
    ridx = np.asarray(ref["ridx"]).astype(np.int64)
    hm = np.asarray(ref["hm"]).astype(np.int64)
    jp = np.asarray(ref["jp"]).astype(np.int64)
    r = np.unique(np.clip(ridx, 0, len(hm) - 1))
    g = r[hm[r] < 0]
    used = len(np.unique(np.clip(hm[r][hm[r] >= 0], 0, ref["nh"] - 1)))
    return (4 * len(ridx) + 12 * len(r)
            + int(np.clip(jp[g], 0, L).sum()) + used * L)


def _refsrc_host(refsrc):
    """The host copies of a source form's arrays that _refsrc_bytes reads."""
    ridx = refsrc[-1].cpu().numpy()
    _g, _gp, hm, jp, hr, _r = refsrc
    return {"ridx": ridx, "hm": hm.cpu().numpy(), "jp": jp.cpu().numpy(),
            "nh": hr.shape[0]}


def _with_refsrc(torch, np, args, seed, dev, Jw):
    """The gathered entry's arguments (_gathered_args') on the card with
    their refbase rows named by index in a window of Jw rows: the window's
    sources (_refbase_inputs: starts negative and past the end, host-row
    indices past the rows) sent up by vote.window_refsrc, and a bucket's
    ridx (unsorted, some repeated, some past the window's rows: they
    clamp). Returns (the arguments on the card with refbase the rows
    these name, the source form)."""
    from gencore_tpu_torch.core import vote
    J, L = args[7].shape
    rng = np.random.default_rng(seed)
    genome, gp, hr, hm, jp = _refbase_inputs(np, rng, Jw, L,
                                             nh=min(64, Jw))
    ridx = rng.permutation(Jw)[:J].astype(np.int32)
    ridx[1::5] = ridx[0]
    ridx[2::17] = Jw + 3
    src = vote.window_refsrc(torch.from_numpy(genome).to(dev), gp, hm, jp, hr)
    ridx = torch.from_numpy(ridx).to(dev)
    gpu = [None if a is None else torch.from_numpy(a).to(dev) for a in args]
    gpu[7] = vote.refbase_rows((*src, ridx), L)
    return gpu, (*src, ridx)


def _forms(vote, gpu, src, kw):
    """The gathered entry of `vote` (a vote module) on the same arguments
    in its two refbase forms: the rows given ([J, L], gpu[7]) and read
    from the window's sources (`src`)."""
    return {"rows": lambda: vote.vote_gathered(*gpu, **kw),
            "sources": lambda: vote.vote_gathered(*gpu[:7], None, gpu[8],
                                                  refsrc=src, **kw)}


def _turns(torch, forms):
    """Each form's device ms (_kernel_ms) in turns: rows, sources,
    sources, rows."""
    turns = {f: [] for f in forms}
    for f in ("rows", "sources", "sources", "rows"):
        turns[f].append(_kernel_ms(torch, forms[f]))
    return turns


def _refsrc_timed(torch, np, dev, J, K, L, phase, Jw=None):
    """The gathered entry reading its refbase rows where they lie, at a
    bucket of J jobs of K members (_pile_inputs) whose rows a window of
    Jw rows names (_with_refsrc): the source form and the rows form
    against the plain twin on the card (refbase_combine, the row gather
    and the plain vote), exact; the source form's device ms, host and
    call ms, the plain twin's and each form's device ms in turns (rows,
    sources, sources, rows); bound and share of the source form."""
    from gencore_tpu_torch.core import vote
    Jw = Jw or J + J // 4 + 1
    arrs = _pile_inputs(np, K, J, L, J + K + L)
    args, kw = _gathered_args(np, arrs, J + K, "sparse_qtable")
    gpu, src = _with_refsrc(torch, np, args, J + K + 1, dev, Jw)
    forms = _forms(vote, gpu, src, kw)
    want = vote.vote_gathered_plain(*gpu[:7], None, gpu[8], refsrc=src, **kw)
    mism = err = 0
    for name, fn in forms.items():
        m, e = _compare(fn(), want)
        torch.cuda.synchronize()
        if m:
            fail(phase, f"gathered entry ({name} form) != its plain twin at "
                        f"J={J}, K={K}, L={L}: {m} mismatches")
        mism, err = mism + m, max(err, e)
    turns = _turns(torch, forms)
    kern = forms["sources"]
    t = _timings(torch, lambda: vote.vote_gathered_plain(
        *gpu[:7], None, gpu[8], refsrc=src, **kw), kern, "vote_kernel", 1, 5,
        profile_plain=False)
    t["host_ms"] = _host_ms(torch, kern, 50)
    host = [None if a is None else a.cpu().numpy() for a in gpu]
    n_bytes, n_ops = _gathered_bound(np, host, kw)
    n_bytes += _refsrc_bytes(np, _refsrc_host(src), L) - J * L
    b_ms, b_by = bound(n_bytes, n_ops)
    return {"J": J, "K": K, "L": L, "Jw": Jw, "split": vote.split_size(K, J),
            "mismatches": mism, "max_abs_err": err, **t,
            "ms_in_turns": {k: sum(v) / len(v) for k, v in turns.items()},
            "ms_turns": turns, "bytes": n_bytes, "int_ops": n_ops,
            "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / t["ms"]}


def phase_upload_score(torch, np):
    """2e: csrc/upload_score.cu against its plain twin (on the card), for
    every combination of the seven static flags besides mate32, on
    staging with the program's edges (workloads.upload_staging): at the
    deep panel's window shape with u16 mate rows and at N_UPLOAD32 rows
    with u32 mate rows; then, at both widths, mate pairs the kernel must
    not take as pairs (`pair_edges`) with the deep panel's flags; timed
    with the flags the deep panel takes (and at N_UPLOAD32 also with
    no_overlap); then the gathered entry's refbase read (K11's
    counterpart) in each form against refbase_combine, the row gather and
    the plain vote (_refsrc_timed) at REFSRC_SHAPES."""
    from gencore_tpu_torch.core import kernels
    from gencore_tpu_torch.tools import workloads
    dev = torch.device("cuda", 0)
    w, L = W_UPLOAD, L_UPLOAD
    per_flags = {N_UPLOAD: [], N_UPLOAD32: []}
    worst = 0
    t_check = time.perf_counter()
    for n, mate32 in ((N_UPLOAD, False), (N_UPLOAD32, True)):
        for bits in range(128):
            flags = tuple(bool(bits >> i & 1) for i in range(7)) + (mate32,)
            rng = np.random.default_rng(2000 + bits + 128 * mate32)
            staging = workloads.upload_staging(
                rng, n, w, L, **dict(zip(kernels.UPLOAD_FLAGS, flags)))
            static = _upload_static(w, L, flags)
            kern, plain = _upload_calls(torch, static, staging, dev)
            mism, err = _upload_compare(kern(), plain())
            worst = max(worst, err)
            if mism:
                fail("2e", f"upload_score kernel != twin at {n} rows with "
                           f"flags {dict(zip(kernels.UPLOAD_FLAGS, flags))}"
                           f": {mism} mismatching bytes")
            per_flags[n].append(mism)
    # the deep panel's flags: 2-bit rows, seq and qual edits, genome rows,
    # mates that overlap
    deep = (True, True, False, True, True, True, False)
    edges = []
    for n, mate32 in ((N_UPLOAD, False), (N_UPLOAD32, True)):
        staging = workloads.upload_staging(
            np.random.default_rng(3000 + mate32), n, w, L, pair_edges=True,
            **dict(zip(kernels.UPLOAD_FLAGS, deep + (mate32,))))
        kern, plain = _upload_calls(
            torch, _upload_static(w, L, deep + (mate32,)), staging, dev)
        mism, err = _upload_compare(kern(), plain())
        worst = max(worst, err)
        if mism:
            fail("2e", f"upload_score kernel != twin on the pair edges at {n}"
                       f" rows: {mism} mismatching bytes")
        edges.append({"n": n, "mate32": mate32, "mismatches": mism})
    t_check = time.perf_counter() - t_check
    timed = _upload_timed_shape(torch, np, N_UPLOAD, deep, dev)
    timed32 = [_upload_timed_shape(torch, np, N_UPLOAD32,
                                   deep[:6] + (no_ov, True), dev)
               for no_ov in (False, True)]
    # K11's counterpart: the gathered entry reading each job's refbase row
    # where it lies, at the ultra-deep run's bucket (28 jobs; K = 512 so
    # that the plain twin stays under a second) and at the deep panel's
    # largest window (16,064 jobs)
    ref = [_refsrc_timed(torch, np, dev, J, K, L_r, "2e")
           for J, K, L_r in REFSRC_SHAPES]
    emit({"phase": "2e", "name": "gc_upload_score vs engine._upload_score_plain"
                                 ", gc_vote_epilogue reading refbase rows "
                                 "where they lie vs refbase_combine + the "
                                 "plain vote",
          "ok": True, "tolerance": "exact (0 mismatching bytes)",
          "upload_score": {"n": [N_UPLOAD, N_UPLOAD32], "w": w, "L": L,
                           "flag_combinations": {
                               f"{n} rows, {'u32' if n > 1 << 16 else 'u16'}"
                               " mates": len(v)
                               for n, v in per_flags.items()},
                           "mismatches": sum(sum(v) for v in
                                             per_flags.values()),
                           "pair_edges": edges,
                           "max_abs_err": worst, "check_s": t_check,
                           "timed": timed, "timed_u32": timed32},
          "refbase": ref})
    return {"upload_score": timed, "upload_score_u32": timed32,
            "max_abs_err": worst, "refbase": ref}


def _upload_timed_shape(torch, np, n, flags, dev):
    """_upload_timed on generated staging of n rows (seed 7) with flags
    (kernels.UPLOAD_FLAGS order)."""
    from gencore_tpu_torch.core import kernels
    from gencore_tpu_torch.tools import workloads
    staging = workloads.upload_staging(
        np.random.default_rng(7), n, W_UPLOAD, L_UPLOAD,
        **dict(zip(kernels.UPLOAD_FLAGS, flags)))
    timed = _upload_timed(torch, np, _upload_static(W_UPLOAD, L_UPLOAD, flags),
                          staging, dev, "2e")
    timed["flags"] = dict(zip(kernels.UPLOAD_FLAGS, flags))
    return timed


def _score_map_plain(kernels):
    """kernels.score_map's signature over the plain twins: the dense
    route's score maps as the port ran them before csrc/upload_dense.cu."""
    def f(seq_all, qual_all, mate_row, my_len, *, meta=None, my_start=None,
          mate_start=None, cmp_len=None, is_left=None, scored=None,
          **tiers):
        if meta is not None:
            return kernels.score_map_packed_plain(
                seq_all, qual_all, my_len, mate_row, meta, **tiers)
        return kernels.score_map_plain(
            seq_all, qual_all, mate_row, my_start, mate_start, cmp_len,
            my_len, is_left, scored, **tiers)
    return f


def _unpack_bound(args, kw):
    """(bytes, int ops) of one dense unpack: the staging read once, seq
    and qual [n, L] and the lengths written once."""
    n, L = args[0].shape[0], kw["L"]
    n_bytes = sum(t.numel() * t.element_size() for t in args) + 2 * n * L \
        + 4 * n
    return n_bytes, OPS_PER_UNPACK_POS * n * L


def _score_seq_need(args, kw):
    """How many seq bytes a score map's data needs: the (row, column) of
    each position in a scored row's overlap, and of its mate's column
    there, counted once (the function reads no other seq byte)."""
    import torch
    seq, _qual, mate, my_len = args
    N, L = seq.shape
    i32 = torch.int32
    if kw.get("meta") is not None:
        m = kw["meta"].to(torch.int64)
        ms, ts, cl = ((m >> s) & b for s, b in ((0, 0xFF), (8, 0xFF),
                                                  (16, 0x1FF)))
        ms, ts, cl = ms.to(i32), ts.to(i32), cl.to(i32)
        scored = ((m >> 26) & 1).bool()
    else:
        ms, ts, cl = (kw[k].to(i32) for k in ("my_start", "mate_start",
                                               "cmp_len"))
        scored = kw["scored"].bool()
    j = torch.arange(L, dtype=i32, device=seq.device)[None, :]
    need = ((j >= ms[:, None]) & (j < (ms + cl)[:, None])
            & (j < my_len.to(i32)[:, None]) & scored[:, None])
    rows, cols = need.nonzero(as_tuple=True)
    delta = torch.remainder(ts - ms, L).to(torch.int64)
    mr = mate.to(torch.int64).clamp(0, N - 1)
    mates = mr[rows] * L + torch.remainder(cols + delta[rows], L)
    hit = need.reshape(-1).clone()
    hit[mates] = True
    return int(hit.sum())


def _score_bound(args, kw):
    """(bytes, int ops) of one score map: qual [N, L] read once, seq once
    where the data needs it (_score_seq_need), the geometry once, score
    and qual [N, L] written once."""
    seq = args[0]
    N, L = seq.shape
    geo = [args[2], args[3]] + [t for t in kw.values()
                                if hasattr(t, "element_size")]
    n_bytes = (N * L + _score_seq_need(args, kw) + 2 * N * L
               + sum(t.numel() * t.element_size() for t in geo))
    return n_bytes, OPS_PER_SCORE_POS * N * L


def _dense_check(torch, kind, args, kw, phase, timed=True):
    """One dense-route kernel call: the kernel (kernels.upload_unpack or
    kernels.score_map) against its plain twin on the card (exact), then,
    where `timed`, its device ms (CUDA events), call ms and the twin's in
    turns, bound and share."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core import kernels
    if kind == "upload_unpack":
        def kern():
            return kernels.upload_unpack(*args, **kw)

        def plain():
            return engine._upload_unpack_plain(
                kw["w"], kw["L"], kw["qual_mode"], kw["seq_mode"])(*args)
        bounds = _unpack_bound
    else:
        twin = _score_map_plain(kernels)

        def kern():
            return kernels.score_map(*args, **kw)

        def plain():
            return twin(*args, **kw)
        bounds = _score_bound
    mism, err = _upload_compare(kern(), plain())
    torch.cuda.synchronize()
    if mism:
        static = {k: v for k, v in kw.items() if isinstance(v, (int, str))}
        fail(phase, f"{kind} kernel != twin at {tuple(args[0].shape)} "
                    f"{static}: {mism} mismatching bytes")
    if not timed:
        return {"rows": int(args[0].shape[0]), "mismatches": mism,
                "max_abs_err": err}
    t = _timings(torch, plain, kern, f"{kind}_kernel", 5, 20)
    n_bytes, n_ops = bounds(args, kw)
    b_ms, b_by = bound(n_bytes, n_ops)
    return {"rows": int(args[0].shape[0]), "mismatches": mism,
            "max_abs_err": err, **t, "bytes": n_bytes, "int_ops": n_ops,
            "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / t["ms"]}


def phase_dense(torch, np):
    """2f: csrc/upload_dense.cu against its plain twins on the card,
    exact: gc_upload_unpack against engine._upload_unpack_plain for the 6
    seq and qual mode pairs at each of DENSE_SHAPES, timed with the
    route's modes (DENSE_TIMED_MODES), and untimed at DENSE_EDGE_WIDTHS
    (2-bit rows of 2, 9 and 38 bytes, so most rows start off a word) with
    DENSE_EDGE_ROWS rows; gc_score_map against
    kernels.score_map_packed_plain (packed, 48,000 rows, L = 160) and
    kernels.score_map_plain (int32, 239,499 rows at L = 160 and 48,000
    rows at L = 320), each timed, then untimed at SCORE_EDGE_SHAPES with
    each of SCORE_EDGE_TIERS. workloads.score_geometry's rows hold the
    edges of the kernel's mate pairs: pairs whose geometry does not
    mirror, pairs with one row unscored, mates that name a third row,
    self and clamped mates, and pairs across a warp's and a block's
    batch of rows."""
    from gencore_tpu_torch.tools import workloads
    dev = torch.device("cuda", 0)
    unpack = []
    worst = 0
    for si, ((n, w, L), timed_modes) in enumerate(zip(DENSE_SHAPES,
                                                      DENSE_TIMED_MODES)):
        for mi, modes in enumerate((sm, qm) for sm in ("2bit", "4bit")
                                   for qm in ("2bit", "4bit", "raw")):
            rng = np.random.default_rng(4000 + 10 * si + mi)
            args = [torch.from_numpy(a).to(dev)
                    for a in workloads.dense_staging(rng, n, w, *modes)]
            kw = dict(w=w, L=L, seq_mode=modes[0], qual_mode=modes[1])
            r = _dense_check(torch, "upload_unpack", args, kw, "2f",
                             timed=modes == timed_modes)
            worst = max(worst, r["max_abs_err"])
            unpack.append({"w": w, "L": L, "seq_mode": modes[0],
                           "qual_mode": modes[1], **r})
            del args
    edges = []
    for wi, w in enumerate(DENSE_EDGE_WIDTHS):
        L = -(-w // 32) * 32
        for mi, modes in enumerate((sm, qm) for sm in ("2bit", "4bit")
                                   for qm in ("2bit", "4bit", "raw")):
            rng = np.random.default_rng(4500 + 10 * wi + mi)
            args = [torch.from_numpy(a).to(dev) for a in
                    workloads.dense_staging(rng, DENSE_EDGE_ROWS, w, *modes)]
            kw = dict(w=w, L=L, seq_mode=modes[0], qual_mode=modes[1])
            r = _dense_check(torch, "upload_unpack", args, kw, "2f",
                             timed=False)
            worst = max(worst, r["max_abs_err"])
            edges.append({"entry": "upload_unpack", **kw,
                          "mismatches": r["mismatches"]})

    def geometry(seed, N, L, packed):
        t = [torch.from_numpy(a).to(dev) for a in workloads.score_geometry(
            np.random.default_rng(seed), N, L, packed)]
        if packed:
            seq, qual, my_len, mate, meta = t
            return (seq, qual, mate, my_len), dict(meta=meta)
        seq, qual, mate, ms, ts, cl, my_len, left, sc = t
        return (seq, qual, mate, my_len), dict(
            my_start=ms, mate_start=ts, cmp_len=cl, is_left=left, scored=sc)

    score = []
    for si, (N, L, packed) in enumerate(DENSE_SCORE_SHAPES):
        args, kw = geometry(5000 + si, N, L, packed)
        r = _dense_check(torch, "score_map", args, {**kw, **SCORE_KW}, "2f")
        worst = max(worst, r["max_abs_err"])
        score.append({"L": L, "packed": packed, **r})
        del args, kw
    for si, (N, L, packed) in enumerate(SCORE_EDGE_SHAPES):
        args, kw = geometry(5500 + si, N, L, packed)
        for tiers in SCORE_EDGE_TIERS:
            r = _dense_check(torch, "score_map", args, {**kw, **tiers},
                             "2f", timed=False)
            worst = max(worst, r["max_abs_err"])
            edges.append({"entry": "score_map", "rows": N, "L": L,
                          "packed": packed, "tiers": tiers,
                          "mismatches": r["mismatches"]})
    emit({"phase": "2f", "name": "gc_upload_unpack vs "
                                 "engine._upload_unpack_plain, gc_score_map "
                                 "vs kernels.score_map_plain / "
                                 "score_map_packed_plain", "ok": True,
          "tolerance": "exact (0 mismatching bytes)",
          "upload_unpack": unpack, "score_map": score, "edges": edges,
          "max_abs_err": worst})
    return {"upload_unpack": unpack, "score_map": score,
            "max_abs_err": worst}


def _cli(args):
    """The port's CLI in-process; returns (rc, captured stderr)."""
    from gencore_tpu_torch import cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, err.getvalue()


@contextlib.contextmanager
def _no_plain_on_card(torch):
    """For the run inside, no plain version runs on CUDA tensors where a
    hand kernel stands for it: vote.py's plain _epilogue_core inside one
    of its Pallas counterparts (pallas_vote_window, pallas_vote_gathered,
    pallas_vote), whose whole body on the card must be hand kernels; and
    anywhere the plain upload rebuild (engine._upload_sparse_fn,
    engine._upload_sparse_trace) and upload-and-score program
    (engine._upload_score_plain), the plain dense unpack
    (engine._upload_unpack_plain), both plain score maps
    (kernels.score_map_plain, kernels.score_map_packed_plain) and their
    tiering (kernels._qual2score), and vote.refbase_combine. Each raises
    there. Yields counts: entries into the counterparts,
    upload-and-score programs run, and plain calls caught."""
    import threading

    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core import kernels, vote
    depth = threading.local()
    lock = threading.Lock()
    seen = {"counterpart_calls": 0, "upload_score_calls": 0,
            "plain_calls_inside": 0}

    def count(key):
        with lock:
            seen[key] += 1

    def entered(kind, key, fn):
        def f(*a, **k):
            count(key)
            setattr(depth, kind, getattr(depth, kind, 0) + 1)
            try:
                return fn(*a, **k)
            finally:
                setattr(depth, kind, getattr(depth, kind) - 1)
        return f

    def plain(kind, name, fn):
        def f(*a, **k):
            on_card = any(isinstance(x, torch.Tensor) and x.is_cuda
                          for x in (*a, *k.values()))
            if kind is None or getattr(depth, kind, 0):
                if kind is not None or on_card:
                    count("plain_calls_inside")
                if on_card:
                    raise AssertionError(
                        f"plain {name} ran on CUDA tensors"
                        + ("" if kind is None else
                           f" inside a {kind} program"))
            return fn(*a, **k)
        return f

    def factory(orig, wrap):
        def g(*a, **k):
            return wrap(orig(*a, **k))
        return g

    with contextlib.ExitStack() as stack:
        for name in ("pallas_vote_window", "pallas_vote_gathered",
                     "pallas_vote"):
            stack.enter_context(_patched(vote, name, entered(
                "vote", "counterpart_calls", getattr(vote, name))))
        stack.enter_context(_patched(vote, "_epilogue_core", plain(
            "vote", "vote._epilogue_core", vote._epilogue_core)))
        stack.enter_context(_patched(vote, "refbase_combine", plain(
            None, "vote.refbase_combine", vote.refbase_combine)))
        stack.enter_context(_patched(
            engine, "_upload_score_fn", factory(
                engine._upload_score_fn,
                lambda fn: entered("upload", "upload_score_calls", fn))))
        for name in ("_upload_score_plain", "_upload_sparse_fn",
                     "_upload_sparse_trace", "_upload_unpack_plain"):
            stack.enter_context(_patched(engine, name, factory(
                getattr(engine, name),
                lambda fn, name=name: plain(None, f"engine.{name}", fn))))
        for name in ("score_map_plain", "score_map_packed_plain",
                     "_qual2score"):
            stack.enter_context(_patched(kernels, name, plain(
                None, f"kernels.{name}", getattr(kernels, name))))
        yield seen


def _guard_ok(phase, seen, deferred=True):
    """Fails the phase unless the counterparts ran, the deferred upload-
    and-score program too where `deferred` (windows that stage sparse),
    and no plain version ran where a kernel stands for it."""
    if (not seen["counterpart_calls"]
            or (deferred and not seen["upload_score_calls"])
            or seen["plain_calls_inside"]):
        fail(phase, f"the plain-version guard saw {seen}: a plain version "
                    "ran on the card where a hand kernel stands for it, or "
                    "a counterpart or the upload-and-score program did not "
                    "run")


@contextlib.contextmanager
def _window_uploads():
    """Records, for each engine window made inside this process, its
    upload staging (`_window_upload`); yields the list."""
    from gencore_tpu_torch import engine
    rec = []
    orig = engine._WorkArrays.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        rec.append(_window_upload(self))
    with _patched(engine._WorkArrays, "__init__", init):
        yield rec


def _window_upload(work):
    """One window's upload staging: mode (sparse: the upload-and-score
    kernel's; dense: csrc/upload_dense.cu's unpack and score map), its
    seq and qual modes, rows (n_pad), widths (w, L) and the
    sizes that decided the mode (dense table rows nd, genome slots ns,
    dense qual rows nq, as far as the sparse staging got)."""
    return {"mode": work.upload_mode, "n_pad": int(work.n_pad),
            "w": int(work.w_host), "L": int(work.L),
            "seq_mode": work.seq_mode, "qual_mode": work.qual_mode,
            **{k: int(v) for k, v in getattr(work, "sparse_sizes",
                                             {}).items()}}


def upload_routes(args):
    """The port's CLI on the card with `args`, printing one JSON line:
    each window's upload staging (`_window_upload`), the launches of the
    upload-and-score kernel and of the dense route's unpack and score map,
    and the run's upload stage seconds."""
    import torch  # noqa: F401

    from gencore_tpu_torch.core import kernels
    n0 = (kernels.UPLOAD_SCORE_LAUNCHES, kernels.UPLOAD_UNPACK_LAUNCHES,
          kernels.SCORE_MAP_LAUNCHES)
    with _window_uploads() as rec:
        rc, err = _cli([*args, "--device", "cuda", "--debug"])
    stages = _stage_seconds(err)
    print(json.dumps({"args": args, "rc": rc, "windows": rec,
                      "upload_score_launches":
                      kernels.UPLOAD_SCORE_LAUNCHES - n0[0],
                      "upload_unpack_launches":
                      kernels.UPLOAD_UNPACK_LAUNCHES - n0[1],
                      "score_map_launches":
                      kernels.SCORE_MAP_LAUNCHES - n0[2],
                      "stages": {k: v for k, v in stages.items()
                                 if k.startswith(("materialize", "score"))}}),
          flush=True)
    return rc


@contextlib.contextmanager
def _patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def phase_small(torch, np):
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.tools import workloads
    from gencore_tpu_torch.tools.make_golden import (digest_records,
                                                     digest_report)
    d = os.path.join(WORK, "small")
    bam, fa, n_reads = workloads.small_panel(d)
    calls = {"pallas_vote_window": 0, "pallas_vote_gathered": 0,
             "pallas_vote": 0}
    originals = {k: getattr(vote, k) for k in calls}
    shifted = []    # the lenDiff-shifted call of the most jobs

    def counted(name):
        def f(*a, **k):
            calls[name] += 1
            if name == "pallas_vote" and (
                    not shifted or a[0].shape[1] > shifted[0][0][0].shape[1]):
                shifted[:] = [([None if x is None else np.array(x)
                                for x in a[:6]], dict(k))]
            return originals[name](*a, **k)
        return f

    with contextlib.ExitStack() as stack:
        for k in calls:
            stack.enter_context(_patched(vote, k, counted(k)))
        vote.LAUNCHES = 0
        vote.WINDOW_LAUNCHES = 0
        rc, _ = _cli(["-i", bam, "-o", os.path.join(d, "port.bam"), "-r", fa,
                      "-j", os.path.join(d, "port.json"),
                      "--html", os.path.join(d, "port.html"),
                      "--device", "cuda"])
        torch.cuda.synchronize()
        launches = {"vote": vote.LAUNCHES, "vote_window": vote.WINDOW_LAUNCHES}
    rc_o, _ = _cli(["-i", bam, "-o", os.path.join(d, "oracle.bam"), "-r", fa,
                    "-j", os.path.join(d, "oracle.json"),
                    "--html", os.path.join(d, "oracle.html"), "--oracle"])
    if rc or rc_o:
        fail(3, f"CLI exit codes port={rc} oracle={rc_o}")
    p = digest_records(os.path.join(d, "port.bam"))
    o = digest_records(os.path.join(d, "oracle.bam"))
    rep_eq = (digest_report(os.path.join(d, "port.json"))
              == digest_report(os.path.join(d, "oracle.json")))
    ok = (p == o and rep_eq and all(launches.values())
          and all(calls.values()))
    res = {"phase": 3, "name": "small end to end vs oracle", "ok": ok,
           "reads_in": n_reads, "records_out": p[0],
           "records_equal": p == o, "report_stats_equal": rep_eq,
           "kernel_launches": launches, "entry_calls": calls}
    if not ok:
        emit(res)
        fail(3, "port output differs from the oracle, or a vote kernel or "
                "entry point did not run")
    res["shifted_call"] = _replay_shifted(torch, np, *shifted[0])
    emit(res)
    return res


def _replay_shifted(torch, np, arrays, kw):
    """The run's lenDiff-shifted call of the most jobs (vote.pallas_vote:
    members the host gathered, [K, S, L]), replayed on the card through
    the gathered entry over its [K*S, L] view against the plain twin,
    exact, with device and call ms, the plain twin's, bound and share.
    A call that named its refbase rows in the window's sources (refsrc)
    replays so, and given the rows (the rows form) too, both exact."""
    from gencore_tpu_torch.core import vote
    dev = torch.device("cuda", 0)
    seq, qual, score, valid, job_len, refbase = arrays
    K, S, L = seq.shape
    kw = {k: v for k, v in kw.items() if k != "device"}
    ref = kw.get("refsrc")

    def up(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    rows = torch.arange(K * S, dtype=torch.int32, device=dev).view(K, S)
    args = [up(seq.reshape(K * S, L), torch.uint8),
            up(qual.reshape(K * S, L), torch.uint8),
            up(score.reshape(K * S, L), torch.int8), rows, rows[0].clone(),
            up(valid, torch.uint8), up(job_len, torch.int32),
            None if refbase is None else up(refbase, torch.uint8), None]
    rows_args, rows_kw = args, kw
    if ref is not None:
        ref = (*ref[:-1], up(ref[-1], torch.int32))
        kw = dict(kw, refsrc=ref)
        rows_args = args[:7] + [vote.refbase_rows(ref, L), None]
        rows_kw = {k: v for k, v in kw.items() if k != "refsrc"}
    want = vote.vote_gathered_plain(*args, **kw)
    mism, err = _compare(vote.vote_gathered(*args, **kw), want)
    mism_rows, err_rows = _compare(vote.vote_gathered(*rows_args, **rows_kw),
                                   want)
    if mism or mism_rows:
        fail(3, f"the shifted call's gathered launch (source form "
                f"{ref is not None}: {mism}; rows form: {mism_rows}) != its "
                f"plain twin")
    t = _timings(torch, lambda: vote.vote_gathered_plain(*args, **kw),
                 lambda: vote.vote_gathered(*args, **kw), "vote_kernel", 2,
                 20, profile_plain=False)
    host = [None if a is None else a.cpu().numpy() for a in rows_args]
    n_bytes, n_ops = _gathered_bound(np, host, {"sparse": False, **rows_kw})
    if ref is not None:
        n_bytes += _refsrc_bytes(np, _refsrc_host(ref), L) - S * L
    b_ms, b_by = bound(n_bytes, n_ops)
    return {"K": K, "S": S, "L": L, "split": vote.split_size(K, S),
            "refsrc": ref is not None, "mismatches": mism + mism_rows,
            "max_abs_err": max(err, err_rows), **t, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / t["ms"]}


def _deep_panel_run(torch, bam, fa, d, golden, extra=()):
    """One CLI run of a golden workload on cuda (with the golden's CLI
    arguments and `extra`); returns (rc, stderr, wall s, records out,
    output and report equal to the golden digests)."""
    from gencore_tpu_torch.tools.make_golden import (digest_records,
                                                     digest_report)
    os.makedirs(d, exist_ok=True)
    out = os.path.join(d, "out.bam")
    js = os.path.join(d, "report.json")
    t0 = time.perf_counter()
    rc, err = _cli(["-i", bam, "-o", out, "-r", fa, "-j", js,
                    "--html", os.path.join(d, "report.html"), "--debug",
                    "--device", "cuda", *golden.get("cli_args", []), *extra])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    if rc:
        return rc, err, t_run, None, False, False
    n_out, h_out = digest_records(out)
    output_ok = (n_out, h_out) == (golden["output"]["records"],
                                   golden["output"]["sha256"])
    report_ok = digest_report(js) == golden["report_stats_sha256"]
    return rc, err, t_run, n_out, output_ok, report_ok


def _golden_workload(name, phase):
    """(bam, fasta, golden, input records, generate s) of a golden
    workload, generated here and held to the golden input digest."""
    from gencore_tpu_torch.tools.make_golden import (digest_records,
                                                     golden_path,
                                                     make_workload)
    with open(golden_path(name)) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    bam, fa = make_workload(name, os.path.join(WORK, "workloads"))
    t_gen = time.perf_counter() - t0
    n_in, h_in = digest_records(bam)
    if (n_in, h_in) != (golden["input"]["records"],
                        golden["input"]["sha256"]):
        fail(phase, f"the generated {name} input differs from the golden "
                    "input")
    return bam, fa, golden, n_in, t_gen


def _stage_seconds(err):
    """A --debug CLI run's stage sums from its stderr: the windowed paths'
    `[stage] name: 1.234s (summed over ...)` lines and the single-shot
    run's `  name   1.234s  12.3%  xN` table."""
    out = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[stage\] (\S+): ([0-9.]+)s", err)}
    out.update((m.group(1), float(m.group(2))) for m in re.finditer(
        r"(?m)^  (\S+) +([0-9.]+)s +[0-9.]+%  x\d+$", err))
    return out


def _io_lines(err):
    """The `I/O: ...` lines of a CLI run's stderr (the CLI prints one)."""
    return [ln for ln in err.splitlines() if ln.startswith("I/O: ")]


def _streaming_line():
    from gencore_tpu_torch.io import native
    return f"I/O: native core ({native.codec()}), streaming path"


def _counters(vote):
    from gencore_tpu_torch.core import kernels
    return {"vote": vote.LAUNCHES, "vote_full": vote.FULL_LAUNCHES,
            "vote_window": vote.WINDOW_LAUNCHES,
            "upload_score": kernels.UPLOAD_SCORE_LAUNCHES,
            "upload_unpack": kernels.UPLOAD_UNPACK_LAUNCHES,
            "score_map": kernels.SCORE_MAP_LAUNCHES,
            "refsrc": vote.REFSRC_LAUNCHES}


@contextlib.contextmanager
def _refbase_reads():
    """Counts, for the run inside, the engine's gathered votes
    (vote.pallas_vote_gathered, and vote.pallas_vote for lenDiff-shifted
    jobs) handed ready-made refbase rows ("rows": a gather of refbase rows
    or a standalone assembly ahead of them) or the rows' indices with the
    window's sources ("sources"); yields the counts."""
    from gencore_tpu_torch.core import vote
    seen = {"rows": 0, "sources": 0}
    origs = {name: getattr(vote, name)
             for name in ("pallas_vote_gathered", "pallas_vote")}

    def counted(name):
        def f(*a, refsrc=None, **k):
            seen["rows" if refsrc is None else "sources"] += 1
            return origs[name](*a, refsrc=refsrc, **k)
        return f

    with _patched(vote, "pallas_vote_gathered",
                  counted("pallas_vote_gathered")), \
            _patched(vote, "pallas_vote", counted("pallas_vote")):
        yield seen


def _zero_counters(vote):
    from gencore_tpu_torch.core import kernels
    vote.LAUNCHES = 0
    vote.FULL_LAUNCHES = 0
    vote.WINDOW_LAUNCHES = 0
    vote.VOTE_ONLY_LAUNCHES = 0
    vote.REFSRC_LAUNCHES = 0
    kernels.UPLOAD_SCORE_LAUNCHES = 0
    kernels.UPLOAD_UNPACK_LAUNCHES = 0
    kernels.SCORE_MAP_LAUNCHES = 0


def phase_full_bins(torch):
    """3b: reads with IUPAC codes (nt16 codes outside =ACGTN) through the
    port's CLI on cuda, against the port's --oracle and the golden digests
    of the JAX CLI; the full-bins vote (csrc/vote.cu, Bins16) must launch."""
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.tools.make_golden import (digest_records,
                                                     digest_report)
    bam, fa, golden, n_in, t_gen = _golden_workload("full_bins", "3b")
    d = os.path.join(WORK, "full_bins")
    _zero_counters(vote)
    rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
        torch, bam, fa, d, golden)
    launches = _counters(vote)
    rc_o, _ = _cli(["-i", bam, "-o", os.path.join(d, "oracle.bam"), "-r", fa,
                    "-j", os.path.join(d, "oracle.json"),
                    "--html", os.path.join(d, "oracle.html"), "--oracle"])
    if rc or rc_o:
        fail("3b", f"CLI exit codes port={rc} oracle={rc_o}: {err[-2000:]}")
    oracle_eq = (digest_records(os.path.join(d, "out.bam"))
                 == digest_records(os.path.join(d, "oracle.bam"))
                 and digest_report(os.path.join(d, "report.json"))
                 == digest_report(os.path.join(d, "oracle.json")))
    ok = out_ok and rep_ok and oracle_eq and launches["vote_full"] > 0
    emit({"phase": "3b", "name": "full-bins data end to end vs oracle and "
                                 "golden", "ok": ok,
          "workload": golden["workload"], "reads_in": n_in,
          "records_out": n_out, "generate_s": t_gen, "run_s": t_run,
          "kernel_launches": launches,
          "kernel_launches_note": "vote_full = 16-bin (Bins16) launches; "
                                  "vote and vote_window = 6-bin launches "
                                  "(none: the one window holds IUPAC codes)",
          "output_digest_equal": out_ok, "report_stats_equal": rep_ok,
          "equal_to_oracle": oracle_eq})
    if not ok:
        fail("3b", "full-bins output differs from the golden digests or the "
                   "oracle, or the 16-bin kernel did not launch")
    return launches


def _gathered_recorder(calls):
    """A stand-in for vote.vote_gathered that calls it and appends copies of
    its arguments (refbase sources included) to `calls`."""
    from gencore_tpu_torch.core import vote
    orig = vote.vote_gathered

    def clone(x):
        if isinstance(x, tuple):
            return tuple(clone(t) for t in x)
        return x.clone() if hasattr(x, "clone") else x

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        calls.append((clone(args), {k: clone(v) for k, v in kw.items()}))
        return out
    return recorded


def _replay_gathered(torch, np, args, kw, phase, plain=False):
    """A recorded gathered launch that read its refbase rows from the
    window's sources, replayed: against the same launch with the rows
    ready-made (the rows form, the rows by vote.refbase_rows), exact; both
    forms' device ms in turns (rows, sources, sources, rows); with `plain`
    also both forms against the plain twin on the card (refbase_combine,
    the row gather, the plain vote), exact, the plain twin's call time and
    the kernel's host and call ms; the source form's bound and share."""
    from gencore_tpu_torch.core import vote
    K, J = args[3].shape
    L = args[0].shape[1]
    ref = kw["refsrc"]
    rows_kw = {k: v for k, v in kw.items() if k != "refsrc"}
    rows_args = list(args)
    rows_args[7] = vote.refbase_rows(ref, L)

    def src():
        return vote.vote_gathered(*args, **kw)

    def rows():
        return vote.vote_gathered(*rows_args, **rows_kw)

    mism, err = _compare(src(), rows())
    torch.cuda.synchronize()
    if mism:
        fail(phase, f"gathered entry reading its refbase rows where they lie "
                    f"!= the same launch given the rows (K={K}, J={J}, "
                    f"L={L}): {mism} mismatches")
    turns = {"rows": [], "sources": []}
    for name, fn in (("rows", rows), ("sources", src), ("sources", src),
                     ("rows", rows)):
        turns[name].append(_kernel_ms(torch, fn))
    res = {"K": K, "J": J, "L": L, "split": vote.split_size(K, J),
           "sparse": kw["sparse"], "qtable": args[8] is not None,
           "mismatches": mism, "max_abs_err": err,
           "ms": sum(turns["sources"]) / 2,
           "ms_rows_form": sum(turns["rows"]) / 2, "ms_turns": turns}
    if plain:
        want = vote.vote_gathered_plain(*args, **kw)
        for name, fn in (("sources", src), ("rows", rows)):
            m, e = _compare(fn(), want)
            torch.cuda.synchronize()
            if m:
                fail(phase, f"gathered entry ({name} form) != its plain "
                            f"twin on a replayed launch (K={K}, J={J}, "
                            f"L={L}): {m} mismatches")
            res["mismatches"] += m
            res["max_abs_err"] = max(res["max_abs_err"], e)
        res["plain_compared"] = True
        del want
        t = _timings(torch, lambda: vote.vote_gathered_plain(*args, **kw),
                     src, "vote_kernel", 1, 5, profile_plain=False)
        res.update(call_ms=t["call_ms"], plain_ms=t["plain_ms"],
                   plain_ms_runs=t["plain_ms_runs"],
                   host_ms=_host_ms(torch, src, 50))
    host = [None if t is None else t.cpu().numpy() for t in args]
    n_bytes, n_ops = _gathered_bound(np, host, rows_kw)
    n_bytes += _refsrc_bytes(np, _refsrc_host(ref), L) - J * L
    b_ms, b_by = bound(n_bytes, n_ops)
    res.update(members=int(host[5].astype(bool).sum()), bytes=n_bytes,
               int_ops=n_ops, bound_ms=b_ms, bound_by=b_by,
               share_of_bound=b_ms / res["ms"])
    return res


def phase_ultradeep(torch, np):
    """7: the ultra-deep amplicon pile (bench.make_ultradeep_workload, 40
    loci x 1,500 pairs, UMI grouping off) through the CLI on cuda against
    its golden digests, with no plain version on the card, no refbase
    gather and no standalone refbase assembly: its ULTRADEEP_GATHERED
    gathered launches each read the jobs' refbase rows from the window's
    sources; wall seconds and reads/s of that run, then a run that
    records each gathered launch's inputs (vote.vote_gathered), replayed
    for its (K, J), split, device time in the source form and in the rows
    form, and share of its bound; the launch of the most jobs also
    against its plain twin (refbase_combine, the row gather, the plain
    vote)."""
    from gencore_tpu_torch.core import vote
    bam, fa, golden, n_in, t_gen = _golden_workload("ultradeep", 7)
    with _no_plain_on_card(torch) as guard, _refbase_reads() as reads:
        _zero_counters(vote)
        rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
            torch, bam, fa, os.path.join(WORK, "ultradeep"), golden)
        launches = _counters(vote)
    if (rc or not (out_ok and rep_ok)
            or launches["vote"] != ULTRADEEP_GATHERED
            or launches["refsrc"] != launches["vote"]
            or reads["rows"]):
        fail(7, f"ultradeep run failed, differs from the golden digests, "
                f"made other than {ULTRADEEP_GATHERED} gathered launches "
                f"reading the window's refbase sources, or gathered refbase "
                f"rows or assembled them apart: rc={rc} {launches} {reads} "
                f"{err[-1500:]}")
    _guard_ok(7, guard)
    io_lines = _io_lines(err)
    if io_lines != [_streaming_line()]:
        fail(7, f"the ultradeep run did not take the streaming path on the "
                f"native core: {io_lines}")
    stages = _stage_seconds(err)

    # a second run records each gathered launch's inputs, replayed after
    calls = []
    with _patched(vote, "vote_gathered", _gathered_recorder(calls)):
        rc, err, t_rec, _n, out_ok2, rep_ok2 = _deep_panel_run(
            torch, bam, fa, os.path.join(WORK, "ultradeep_rec"), golden)
    if rc or not (out_ok2 and rep_ok2) or _io_lines(err) != io_lines:
        fail(7, f"recorded ultradeep run failed, differs or took another "
                f"path: rc={rc} {_io_lines(err)}")
    most = max(range(len(calls)), key=lambda i: calls[i][0][3].shape[1])
    per_launch = [_replay_gathered(torch, np, args, kw, 7, plain=i == most)
                  for i, (args, kw) in enumerate(calls)]
    del calls
    res = {"phase": 7, "name": "ultra-deep pile vs golden", "ok": True,
           "workload": golden["workload"], "io_line": io_lines[0],
           "cli_args": golden.get("cli_args", []), "reads_in": n_in,
           "records_out": n_out, "generate_s": t_gen, "run_s": t_run,
           "reads_per_s": n_in / t_run, "run_s_recorded": t_rec,
           "kernel_launches": launches, "plain_guard": guard,
           "refbase_reads": reads, "gathered_launches": per_launch,
           "gathered_vote_ms": sum(p["ms"] for p in per_launch),
           "refsrc_largest": per_launch[most],
           "output_digest_equal": out_ok, "report_stats_equal": rep_ok,
           "stage_seconds": stages}
    emit(res)
    return res, (bam, fa, golden)


def _dense_recorder(torch, largest):
    """Stand-ins for kernels.upload_unpack and kernels.score_map that call
    them and keep, in largest["upload_unpack"] / largest["score_map"],
    copies of the arguments of the call of the most rows (replayed after
    the run)."""
    from gencore_tpu_torch.core import kernels

    def rec(key, orig):
        def f(*a, **k):
            if a[0].shape[0] > largest.get(key, {}).get("rows", -1):
                largest[key] = {
                    "rows": a[0].shape[0],
                    "args": [t.clone() for t in a],
                    "kw": {kk: v.clone() if isinstance(v, torch.Tensor)
                           else v for kk, v in k.items()}}
            return orig(*a, **k)
        return f
    return (rec("upload_unpack", kernels.upload_unpack),
            rec("score_map", kernels.score_map))


def phase_long_reads(torch, np):
    """7b: the long_amplicon panel (2x300 reads, so every window stages
    dense and votes at L = 320 through csrc/vote.cu's gathered entry)
    through the CLI's default streaming path on cuda against its golden
    digests, with no plain version on the card: the dense unpack and
    score map and LONG_AMPLICON_GATHERED gathered votes at L = 320, each
    reading the jobs' refbase rows from the window's sources, must launch,
    with no refbase gather and no standalone refbase assembly; wall
    seconds and reads/s of that run, then its largest unpack and score
    map (recorded in the run) replayed against their twins and timed, and
    its gathered launch of the most (member, job) slots replayed in the
    source form and the rows form and against its plain twin."""
    from gencore_tpu_torch.core import kernels, vote
    bam, fa, golden, n_in, t_gen = _golden_workload("long_amplicon", "7b")
    largest = {}
    gathered_L = []
    calls = []
    rec_g = _gathered_recorder(calls)

    def counted_g(*a, **k):
        gathered_L.append(int(a[0].shape[1]))
        out = rec_g(*a, **k)
        calls.sort(key=lambda c: -c[0][3].numel())
        del calls[1:]          # keep the launch of the most slots
        return out

    u_rec, s_rec = _dense_recorder(torch, largest)
    with _patched(kernels, "upload_unpack", u_rec), \
            _patched(kernels, "score_map", s_rec), \
            _patched(vote, "vote_gathered", counted_g), \
            _window_uploads() as windows, \
            _no_plain_on_card(torch) as guard, \
            _refbase_reads() as reads:
        _zero_counters(vote)
        rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
            torch, bam, fa, os.path.join(WORK, "long_amplicon"), golden)
        launches = _counters(vote)
    if rc:
        fail("7b", f"CLI exit code {rc}: {err[-2000:]}")
    _guard_ok("7b", guard, deferred=False)
    io_lines = _io_lines(err)
    stages = _stage_seconds(err)
    res = {"phase": "7b", "name": "long_amplicon (2x300, dense windows, "
                                  "L = 320) vs golden, streaming path",
           "ok": True, "workload": golden["workload"], "io_line": io_lines,
           "reads_in": n_in, "records_out": n_out, "generate_s": t_gen,
           "run_s": t_run, "reads_per_s": n_in / t_run, "windows": windows,
           "gathered_launch_L": sorted(set(gathered_L)),
           "kernel_launches": launches, "plain_guard": guard,
           "refbase_reads": reads,
           "output_digest_equal": out_ok, "report_stats_equal": rep_ok,
           "stage_seconds": stages}
    if not (out_ok and rep_ok and io_lines == [_streaming_line()] and windows
            and all(w["mode"] == "dense" and w["L"] == 320 for w in windows)
            and launches["vote"] == LONG_AMPLICON_GATHERED
            and gathered_L == [320] * len(gathered_L)
            and launches["refsrc"] == launches["vote"]
            and not reads["rows"]
            and launches["upload_unpack"] == len(windows)
            and launches["score_map"] > 0):
        res["ok"] = False
        emit(res)
        fail("7b", "the long-read panel differs from the golden digests, "
                   "left the streaming path, staged a window sparse or not "
                   "at L = 320, did not launch the dense kernels or "
                   f"{LONG_AMPLICON_GATHERED} gathered votes at L = 320 "
                   "reading the window's refbase sources, or gathered "
                   "refbase rows or assembled them apart")
    for kind in ("upload_unpack", "score_map"):
        rec = largest.pop(kind)
        kw = rec["kw"]
        res[f"{kind}_largest"] = {
            "modes": {k: kw[k] for k in ("seq_mode", "qual_mode")}
            if kind == "upload_unpack" else {"packed": "meta" in kw and
                                             kw["meta"] is not None},
            "L": int(rec["args"][0].shape[1]) if kind == "score_map"
            else kw["L"],
            **_dense_check(torch, kind, rec["args"], kw, "7b")}
    res["gathered_largest"] = _replay_gathered(torch, np, *calls[0], "7b",
                                               plain=True)
    del calls
    emit(res)
    return res, (bam, fa, golden)


def _window_recorder(np, vote, largest, per_launch=None, qtables=None):
    """A stand-in for vote.pallas_vote_window that calls it and keeps, in
    `largest`, the inputs of the launch with the most members (replayed
    later); per_launch / qtables get each launch's classes (K, J, sum of
    member counts) and whether it had a qual nibble table."""
    orig = vote.pallas_vote_window

    def recorded(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
                 qtable, class_args, **kw):
        info = [[K, J, int(np.asarray(class_args[4 * ci + 1])
                         .astype(np.int64).sum())]
                for ci, (K, J) in enumerate(kw["classes"])]
        if per_launch is not None:
            per_launch.append(info)
            qtables.append(qtable is not None)
        tot = sum(x[2] for x in info)
        if tot > largest["sum_counts"]:
            largest.update(
                sum_counts=tot, classes=info,
                args=[t.clone() for t in (seq_dev, qual_dev, score_dev)]
                + [genome] + [np.array(a) for a in (gp, hr, hm, jp)]
                + [None if qtable is None else np.array(qtable),
                   [np.array(a) for a in class_args]], kw=dict(kw))
        return orig(seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp,
                    qtable, class_args, **kw)

    return recorded


def _upload_recorder(upload):
    """A stand-in for engine._upload_score_fn whose functions keep, in
    `upload`, the static arguments and staging of the deferred upload of
    the most rows (replayed in phase 5)."""
    from gencore_tpu_torch import engine
    orig = engine._upload_score_fn

    def factory(*static):
        fn = orig(*static)

        def f(*staging, **kw):
            n = len(staging[1])
            if n > upload.get("n", -1):
                upload.update(n=n, static=static, staging=[
                    a if hasattr(a, "is_cuda") else a.copy()
                    for a in staging])
            return fn(*staging, **kw)
        return f
    return factory


def phase_full(torch, np):
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.io import native
    from gencore_tpu_torch.parallel import streaming
    from gencore_tpu_torch.tools import workloads
    from gencore_tpu_torch.tools.make_golden import GOLDEN, digest_records
    with open(GOLDEN) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    bam, fa = workloads.deep_panel(os.path.join(WORK, "workloads"))
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_in, h_in = digest_records(bam)
    t_setup = time.perf_counter() - t0
    input_ok = (n_in, h_in) == (golden["input"]["records"],
                                golden["input"]["sha256"])
    if not input_ok:
        fail(4, "the generated input differs from the golden input")

    per_launch = []
    qtables = []
    largest = {"sum_counts": -1}
    streamed = []
    orig_stream = streaming.run_streaming

    def counted_stream(*a, **k):
        streamed.append(k.get("device"))
        return orig_stream(*a, **k)

    recorded = _window_recorder(np, vote, largest, per_launch, qtables)
    upload = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the guard goes on last, so that it wraps the recorders
    with _patched(vote, "pallas_vote_window", recorded), \
            _patched(engine, "_upload_score_fn", _upload_recorder(upload)), \
            _patched(streaming, "run_streaming", counted_stream), \
            _no_plain_on_card(torch) as guard:
        _zero_counters(vote)
        rc, err, t_run, n_out, output_ok, report_ok = _deep_panel_run(
            torch, bam, fa, os.path.join(WORK, "full"), golden)
        launches = _counters(vote)
    peak = torch.cuda.max_memory_allocated()
    if rc:
        fail(4, f"CLI exit code {rc}: {err[-2000:]}")
    _guard_ok(4, guard)
    io_lines = _io_lines(err)
    if len(streamed) != 1 or io_lines != [_streaming_line()]:
        fail(4, f"the deep panel did not go through run_streaming once on "
                f"the native core: calls={len(streamed)} lines={io_lines}")
    stages = _stage_seconds(err)
    ok = (output_ok and report_ok and launches["vote_window"] > 0
          and launches["vote_window"] == len(per_launch)
          and launches["upload_score"] == guard["upload_score_calls"] > 0)
    emit({"phase": 4, "name": "full-size deep panel vs golden, streaming "
                              "path", "ok": ok,
          "path": "parallel/streaming.run_streaming", "io_line": io_lines[0],
          "codec": native.codec(),
          "qual_nibble_table_per_launch": qtables,
          "workload": golden["workload"], "reads_in": n_in,
          "records_out": n_out, "generate_s": t_gen, "setup_s": t_setup,
          "run_s": t_run, "reads_per_s": n_in / t_run,
          "max_memory_allocated": peak, "kernel_launches": launches,
          "plain_guard": guard,
          "window_launches_K_J_sumcounts": per_launch,
          "input_digest_equal": input_ok, "output_digest_equal": output_ok,
          "report_stats_equal": report_ok, "stage_seconds": stages})
    if not ok:
        fail(4, "output differs from the golden digests, or the fused "
                "window kernel's (upload-and-score kernel's) launches do "
                "not match the window calls (deferred uploads)")
    largest["upload"] = upload
    return bam, fa, golden, launches, largest


def phase_shards(torch, bam, fa, golden, n_shards=4):
    """4b: the deep panel with --shards and --checkpoint_dir, then resumed
    after one shard's files were deleted."""
    import shutil

    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.parallel import resume
    ckdir = os.path.join(WORK, "shards_ck")
    shutil.rmtree(ckdir, ignore_errors=True)
    extra = ["--shards", str(n_shards), "--checkpoint_dir", ckdir]
    done = {"recorded": [], "loaded": []}
    orig_rec = resume.WindowCheckpoint.record_shard
    orig_load = resume.WindowCheckpoint.load_shard

    def record_shard(self, shard, *a, **k):
        done["recorded"].append(shard)
        return orig_rec(self, shard, *a, **k)

    def load_shard(self, shard):
        done["loaded"].append(shard)
        return orig_load(self, shard)

    runs = []
    lost = None
    with _patched(resume.WindowCheckpoint, "record_shard", record_shard), \
            _patched(resume.WindowCheckpoint, "load_shard", load_shard):
        for tag in ("first", "resumed"):
            done["recorded"], done["loaded"] = [], []
            with _no_plain_on_card(torch) as guard:
                _zero_counters(vote)
                rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
                    torch, bam, fa, os.path.join(WORK, f"shards_{tag}"),
                    golden, extra)
                launches = _counters(vote)
            if rc or not (out_ok and rep_ok):
                fail("4b", f"--shards {n_shards} run ({tag}) failed or "
                           f"differs from the golden digests: rc={rc} "
                           f"{err[-1500:]}")
            _guard_ok("4b", guard)
            runs.append({"run": tag, "run_s": t_run, "records_out": n_out,
                         "plain_guard": guard,
                         "shards_computed": list(done["recorded"]),
                         "shards_loaded": list(done["loaded"]),
                         "kernel_launches": launches,
                         "io_line": next((ln for ln in err.splitlines()
                                          if ln.startswith("I/O: ")), None)})
            if tag == "first":
                # a shard that the first run computed (one without reads
                # writes nothing), from the middle of the genome
                lost = done["recorded"][len(done["recorded"]) // 2]
                for f in os.listdir(ckdir):
                    if f.startswith(f"shard_{lost}."):
                        os.remove(os.path.join(ckdir, f))
    every = runs[0]["shards_computed"]
    ok = (len(every) > 1 and every == sorted(set(every))
          and runs[0]["shards_loaded"] == []
          and runs[1]["shards_computed"] == [lost]
          and runs[1]["shards_loaded"] == [s for s in every if s != lost]
          and runs[0]["kernel_launches"]["vote_window"] >= len(every)
          and runs[1]["kernel_launches"]["vote_window"] >= 1)
    emit({"phase": "4b", "name": "deep panel, --shards with checkpoint and "
                                 "resume, vs golden", "ok": ok,
          "n_shards": n_shards, "deleted_shard": lost, "runs": runs,
          "output_digest_equal": True, "report_stats_equal": True})
    if not ok:
        fail("4b", "the sharded runs did not compute and load the shards "
                   "expected, or launched no window vote")
    return runs


@contextlib.contextmanager
def _environ(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _without_native_core():
    """The process as it is where the native core cannot be had: get_lib()
    decides anew under GENCORE_NO_NATIVE; the loaded core comes back after."""
    from gencore_tpu_torch.io import native
    saved = (native._lib, native._tried, native.BUILD_LOG)
    native._lib, native._tried = None, False
    try:
        with _environ(GENCORE_NO_NATIVE="1"):
            yield
    finally:
        native._lib, native._tried, native.BUILD_LOG = saved


def phase_in_memory(torch, bam, fa, golden, n_windows=5):
    """4c: the deep panel through the in-memory window pipeline
    (parallel/pipeline.run_pipelined), the CLI's path for an input it does
    not stream: once with the native core, each window written as it
    retires (the out_writer route), and once as on a machine without the
    core, pure-Python codec and the windows merged into one payload
    (merged_payload). Both against the golden digests."""
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.io import native
    from gencore_tpu_torch.parallel import pipeline
    codec = native.codec()
    calls = []
    merged = []
    orig_run = pipeline.run_pipelined
    orig_merged = pipeline.merged_payload

    def counted_run(*a, **k):
        calls.append(k.get("out_writer") is not None)
        return orig_run(*a, **k)

    def counted_merged(tables):
        merged.append(len(tables))
        return orig_merged(tables)

    runs = {}
    cases = (("out_writer", contextlib.nullcontext,
              f"I/O: native core ({codec}), in-memory window pipeline",
              [True], False),
             ("merged_payload", _without_native_core,
              "I/O: pure-Python codec (native core unavailable: "
              "GENCORE_NO_NATIVE is set), in-memory window pipeline",
              [False], True))
    for tag, core, want_io, want_calls, want_merged in cases:
        del calls[:], merged[:]
        with _patched(pipeline, "run_pipelined", counted_run), \
                _patched(pipeline, "merged_payload", counted_merged), \
                _environ(GENCORE_NO_STREAM="1"), core(), \
                _no_plain_on_card(torch) as guard:
            _zero_counters(vote)
            rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
                torch, bam, fa, os.path.join(WORK, f"in_memory_{tag}"),
                golden, ["--windows", str(n_windows)])
            launches = _counters(vote)
        if rc:
            fail("4c", f"CLI exit code {rc} ({tag}): {err[-2000:]}")
        _guard_ok("4c", guard)
        stages = _stage_seconds(err)
        runs[tag] = {"io_line": _io_lines(err), "run_s": t_run,
                     "records_out": n_out, "kernel_launches": launches,
                     "output_digest_equal": out_ok,
                     "report_stats_equal": rep_ok,
                     "plain_guard": guard,
                     "run_pipelined_out_writer": list(calls),
                     "merged_payload_windows": list(merged),
                     "stage_seconds": stages}
        ok = (out_ok and rep_ok and _io_lines(err) == [want_io]
              and calls == want_calls and bool(merged) == want_merged
              and launches["vote_window"] > 0)
        if not ok:
            emit({"phase": "4c", "ok": False, "run": tag, **runs[tag]})
            fail("4c", f"the in-memory window pipeline ({tag}) differs from "
                       "the golden digests, took another path, or launched "
                       "no window vote")
    if native.codec() != codec:
        fail("4c", "the native core did not come back after the run "
                   "without it")
    emit({"phase": "4c", "name": "deep panel, in-memory window pipeline "
                                 "(GENCORE_NO_STREAM), with and without the "
                                 "native core, vs golden", "ok": True,
          "n_windows": n_windows, **runs})
    return runs


def phase_single_shot(torch, bam, fa, golden):
    """4d: the deep panel single-shot (`--windows 1`: one window of
    239,499 rows, whose sparse staging would pass the u16 row limit, so it
    stages dense) against the golden digests, with no plain version on
    the card: the dense unpack and score map of csrc/upload_dense.cu must
    launch."""
    from gencore_tpu_torch.core import vote
    with _window_uploads() as windows, _no_plain_on_card(torch) as guard:
        _zero_counters(vote)
        rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
            torch, bam, fa, os.path.join(WORK, "single_shot"), golden,
            ["--windows", "1"])
        launches = _counters(vote)
    if rc:
        fail("4d", f"CLI exit code {rc}: {err[-2000:]}")
    _guard_ok("4d", guard, deferred=False)
    dense = [w for w in windows if w["mode"] == "dense"]
    stages = _stage_seconds(err)
    res = {"phase": "4d", "name": "deep panel single-shot (--windows 1, "
                                  "dense staging) vs golden",
           "ok": True, "io_line": _io_lines(err), "windows": windows,
           "run_s": t_run, "reads_per_s": golden["input"]["records"] / t_run,
           "records_out": n_out, "kernel_launches": launches,
           "plain_guard": guard, "output_digest_equal": out_ok,
           "report_stats_equal": rep_ok, "stage_seconds": stages}
    if not (out_ok and rep_ok and dense
            and launches["upload_unpack"] == len(dense)
            and launches["score_map"] > 0):
        res["ok"] = False
        emit(res)
        fail("4d", "the single-shot deep panel differs from the golden "
                   "digests, staged no dense window, or did not launch the "
                   "dense unpack and score map")
    emit(res)
    return res


def phase_mesh(torch, np):
    """8: parallel/mesh.py with one rank on the card against the plain
    vote (exact): a one-device mesh, and a torch.distributed group (NCCL)
    of this one process."""
    import socket

    from gencore_tpu_torch.core import kernels, vote
    from gencore_tpu_torch.options import Options
    from gencore_tpu_torch.parallel import distributed, mesh
    J, K, L = 2048, 8, L_PHASE2
    rng = np.random.default_rng(88)
    bases = np.array([1, 2, 4, 8], dtype=np.uint8)
    seq = bases[rng.integers(0, 4, size=(J, K, L))]
    seq = np.where(rng.random((J, K, L)) < 0.9, seq[:, :1, :], seq)
    seq = np.where(rng.random((J, K, L)) < 0.03,
                   rng.integers(0, 16, size=(J, K, L)), seq).astype(np.uint8)
    qual = rng.integers(2, 42, size=(J, K, L)).astype(np.uint8)
    score = rng.integers(-4, 13, size=(J, K, L)).astype(np.int32)
    valid = rng.random((J, K)) < 0.85
    valid[:, 0] = True
    pos_valid = np.arange(L)[None, :] < rng.integers(1, L + 1, size=J)[:, None]
    refbase = np.where(rng.random((J, L)) < 0.2, 0,
                       bases[rng.integers(0, 4, size=(J, L))]).astype(np.uint8)
    batch = (seq, qual, score, valid, pos_valid, refbase)
    opt = Options()
    rnum, rden = kernels.ratio_fraction(opt.score_percent_req)
    want = kernels.consensus_plain(
        *[torch.from_numpy(a) for a in batch], hi=opt.high_quality,
        mod=opt.moderate_quality, lo=opt.low_quality,
        base_score_req=opt.base_score_req, ratio_num=rnum, ratio_den=rden)
    want = [*want, want[2].sum(dtype=torch.int64),
            (want[3] > 5).sum(dtype=torch.int64)]
    partials = rng.integers(0, 2**40, size=(1, 64), dtype=np.int64)

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    res = {}
    distributed.init_runtime(f"127.0.0.1:{port}", 1, 0, device="cuda",
                             timeout_s=120)
    try:
        meshes = (("one_device", mesh.make_mesh(1, device="cuda"),
                   partials),
                  ("nccl_group_of_one", mesh.make_mesh(device="cuda",
                                                       group=True),
                   partials[0]))
        for tag, m, part in meshes:
            _zero_counters(vote)
            t0 = time.perf_counter()
            got = mesh.sharded_consensus_step(m, *batch, opt)
            total = mesh.stats_psum(m, part)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            mism = sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
            mism += int((total.cpu().numpy() != partials.sum(axis=0)).sum())
            res[tag] = {"mesh_size": m.size, "mismatches": mism,
                        "seconds": dt, "total_diff": int(got[4]),
                        "rolled_back": int(got[5]),
                        "kernel_launches": _counters(vote)}
    finally:
        distributed.shutdown_runtime()
    ok = all(r["mismatches"] == 0 and r["kernel_launches"]["vote_full"] == 1
             for r in res.values())
    emit({"phase": 8, "name": "mesh.sharded_consensus_step and stats_psum, "
                              "one rank, vs the plain vote", "ok": ok,
          "tolerance": "exact (0 mismatches)", "J": J, "K": K, "L": L, **res})
    if not ok:
        fail(8, "the job-sharded vote or the stats reduction differs from "
                "the plain version, or did not launch the Bins16 kernel")
    return res


def _replay_window(torch, largest, phase):
    """A recorded window launch replayed through the fused kernel and its
    plain twin (on the CPU); fails the phase on any mismatching byte.
    Returns (matrices and genome on the card,
    the refbase sources, qual table, class args, kw, mismatches, max abs
    err)."""
    from gencore_tpu_torch.core import vote
    (seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
     class_args) = largest["args"]
    kw = largest["kw"]
    mats = (seq_dev, qual_dev, score_dev, genome)
    srcs = (gp, hr, hm, jp)
    got = vote.vote_window(*mats, *srcs, qtable, class_args, **kw)
    torch.cuda.synchronize()
    want = vote.vote_window_plain(*[t.cpu() for t in mats], *srcs, qtable,
                                  class_args, **kw)
    mism, err = _compare_window(got, want)
    if mism:
        fail(phase, f"vote_window kernel != twin on a replayed launch "
                    f"{largest['classes']}: {mism} mismatching bytes")
    return mats, srcs, qtable, class_args, kw, mism, err


def phase_replay(torch, np, largest):
    """The deep panel's largest window launch, replayed: the kernel
    against the plain composition on the card (refbase_combine,
    vote_core_plain, _epilogue_core, concat_sparse); and the largest
    deferred upload through the upload-and-score kernel against its
    twin."""
    from gencore_tpu_torch.core import kernels, vote
    mats, srcs, qtable, class_args, kw, mism, err = _replay_window(
        torch, largest, 5)
    t = _timings(
        torch,
        lambda: vote.vote_window_plain(*mats, *srcs, qtable, class_args,
                                       **kw),
        lambda: vote.vote_window(*mats, *srcs, qtable, class_args, **kw),
        "vote_window_kernel", 5, 50)
    N, L = mats[0].shape
    n_bytes, n_ops, n_members = _window_bound(
        np, class_args, kw["classes"], N, L, (None, *srcs),
        kw["out_len"] or L, qtable)
    b_ms, b_by = bound(n_bytes, n_ops)
    Jt = sum(J for _K, J in kw["classes"])
    grid = vote.window_grid(L, Jt, mats[0].device)
    up = largest["upload"]
    up_res = _upload_timed(torch, np, up["static"], up["staging"],
                           mats[0].device, 5)
    res = {"classes_K_J_sumcounts": largest["classes"], "N": N, "L": L,
           "Jw": len(srcs[0]), "host_rows": len(srcs[1]),
           "job_positions": Jt * L, "grid_blocks": grid,
           "blocks_per_sm": grid / torch.cuda.get_device_properties(
               mats[0].device).multi_processor_count,
           "out_len": kw["out_len"], "qtable": qtable is not None,
           "mismatches": mism, "max_abs_err": err, **t, "bytes": n_bytes,
           "int_ops": n_ops, "bound_ms": b_ms, "bound_by": b_by,
           "share_of_bound": b_ms / t["ms"],
           "upload_score": {**up_res, "flags": dict(zip(
               kernels.UPLOAD_FLAGS, (*up["static"][2:7],
                                      *up["static"][14:16])))}}
    emit({"phase": 5, "name": "largest deep-panel window launch and "
                              "deferred upload, replayed", "ok": True, **res})
    return res


def _device_activity(trace_path):
    """From a torch.profiler Chrome trace: kernel, memcpy and memset counts,
    the union of their intervals (device busy, ms), and the vote kernels'
    summed time."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    iv = []
    counts = {"kernel": 0, "gpu_memcpy": 0, "gpu_memset": 0}
    vote_us = 0.0
    for e in events:
        cat = e.get("cat")
        if cat in counts and "ts" in e and "dur" in e:
            counts[cat] += 1
            iv.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if cat == "kernel" and "vote" in e.get("name", ""):
                vote_us += float(e["dur"])
    iv.sort()
    busy = 0.0
    end = None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span = (iv[-1][1] - iv[0][0]) if iv else 0.0
    return {"kernels": counts["kernel"], "memcpys": counts["gpu_memcpy"],
            "memsets": counts["gpu_memset"], "device_busy_ms": busy / 1e3,
            "device_span_ms": span / 1e3, "vote_kernels_ms": vote_us / 1e3}


def _upload_before(torch):
    """kernels.upload_score as the port ran the program before
    csrc/upload_score.cu: each staging array copied up alone (u16/u32
    widened to int32), then the plain program (~240 launches)."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core.vote import to_device

    def f(arrays, genome, *, device, w, L, mode2, has_sedit, has_qdense,
          has_qedit, const_lens, has_genome, no_overlap, hi, mod, lo, s_hi,
          s_mod, s_lo, s_bad, mate32=False):
        g = genome if isinstance(genome, torch.Tensor) else \
            torch.zeros(1, dtype=torch.uint8, device=device)
        static = (w, L, mode2, has_sedit, has_qdense, has_qedit, const_lens,
                  hi, mod, lo, s_hi, s_mod, s_lo, s_bad, has_genome,
                  no_overlap, mate32)
        return engine._upload_score_plain(*static)(
            *[to_device(a, device) for a in arrays[:14]], g,
            to_device(arrays[14], device))
    return f


def _refsrc_before():
    """vote.vote_gathered as the port ran a bucket before its refbase read
    moved into csrc/vote.cu: the window's refbase rows assembled and the
    bucket's rows gathered in plain PyTorch (vote.refbase_rows, ~20
    launches), then the rows form."""
    from gencore_tpu_torch.core import vote
    orig = vote.vote_gathered

    def f(*a, refsrc=None, **k):
        if refsrc is None:
            return orig(*a, **k)
        a = list(a)
        a[7] = vote.refbase_rows(refsrc, a[0].shape[1])
        return orig(*a, **k)
    return f


def _dense_upload_before():
    """engine._WorkArrays.upload as the port ran the dense route before
    csrc/upload_dense.cu: the four staging arrays copied up one by one,
    then the plain unpack."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core.vote import to_device

    def upload(self, device):
        return engine._upload_unpack_plain(
            self.w_host, self.L, self.qual_mode, self.seq_mode)(
            *[to_device(a, device) for a in (
                self.seq_up, self.qual_up, self.lens, self.qtable16)])
    return upload


def phase_busy(torch, np, runs):
    """6: one profiled run of each workload in `runs` ((tag, bam, fasta,
    golden, extra CLI arguments, whether it must stream)) before, with the
    compositions the port's kernels replaced put back for that run only
    (the plain upload-and-score program after 16 copies, the plain
    refbase assembly and row gather ahead of each gathered vote, the dense
    route's plain unpack after four copies and its plain score maps), and
    after. A run whose trace holds
    fewer kernels than its kernel wrappers launched (the profiler drops
    records now and then) is profiled again, up to three times in all."""
    from torch.profiler import ProfilerActivity, profile

    from gencore_tpu_torch import engine
    from gencore_tpu_torch.core import kernels, vote
    res = {}
    for wl, bam, fa, golden, extra, streams in runs:
        res[wl] = {}
        for tag in ("before", "after"):
            d = os.path.join(WORK, f"busy_{wl}_{tag}")
            os.makedirs(d, exist_ok=True)
            # the profiler now and then drops a run's kernel records (a
            # trace with fewer kernels than the kernel wrappers counted):
            # such a run is profiled again, up to three times
            for attempt in range(1, 4):
                with contextlib.ExitStack() as stack:
                    if tag == "before":
                        stack.enter_context(_patched(
                            kernels, "upload_score", _upload_before(torch)))
                        stack.enter_context(_patched(
                            vote, "vote_gathered", _refsrc_before()))
                        stack.enter_context(_patched(
                            engine._WorkArrays, "upload",
                            _dense_upload_before()))
                        stack.enter_context(_patched(
                            kernels, "score_map",
                            _score_map_plain(kernels)))
                    _zero_counters(vote)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        rc, err, t_run, _n, out_ok, rep_ok = _deep_panel_run(
                            torch, bam, fa, d, golden, extra)
                    counted = _counters(vote)
                    counted["vote_alone"] = vote.VOTE_ONLY_LAUNCHES
                if rc or not (out_ok and rep_ok):
                    fail(6, f"profiled {wl} run ({tag}) failed or differs "
                            f"from the golden digests: rc={rc} "
                            f"{err[-1000:]}")
                if streams and _io_lines(err) != [_streaming_line()]:
                    fail(6, f"profiled {wl} run ({tag}) did not take the "
                            "streaming path on the native core: "
                            f"{_io_lines(err)}")
                trace = os.path.join(d, "trace.json")
                prof.export_chrome_trace(trace)
                act = _device_activity(trace)
                os.remove(trace)
                if act["kernels"] >= sum(counted.values()):
                    break
            res[wl][tag] = {"wall_s_profiled": t_run,
                            "kernel_launches": counted,
                            "profiled_runs": attempt, **act}
        b, a = res[wl]["before"], res[wl]["after"]
        res[wl]["fewer"] = {k: b[k] - a[k] for k in ("kernels", "memcpys",
                                                    "memsets")}
    emit({"phase": 6, "name": "device busy, kernels and memcpys per run, "
                              "before/after", "ok": True,
          "before": "the plain upload-and-score program "
                    "(engine._upload_score_plain after 16 copies up), "
                    "the plain refbase assembly and row gather ahead of "
                    "each gathered vote (vote.refbase_rows) and the dense "
                    "route's plain unpack (engine._upload_unpack_plain "
                    "after four copies up) and score maps "
                    "(kernels.score_map_plain, score_map_packed_plain), "
                    "substituted for that run only",
          "after": "csrc/upload_score.cu (one copy up, one launch per "
                   "window), csrc/vote.cu reading each job's refbase row "
                   "where it lies (the window's sources in one copy) and "
                   "csrc/upload_dense.cu (one copy up, one unpack and one "
                   "score-map launch per dense window)",
          **res})
    return res


def phase_cases(torch, np):
    """9: the case matrix of tools/golden_compare.py (15 CLI cases over
    the JAX CLI's option surface) on every route each case allows, through
    the port's CLI on cuda, each run held to the case's golden digests
    (input, ordered output records, JSON report, normalized HTML report)
    and required to launch a vote kernel (counters zeroed just before each
    run); then, at L = 128, defaults_noumi's window launch replayed through
    vote_window against vote_window_plain, and vote_core against
    vote_core_plain on inputs of that launch's shape."""
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.tools import golden_compare as gc
    wd = os.path.join(WORK, "cases")
    t0 = time.perf_counter()
    for case in gc.CASES.values():
        gc.prepare(case, wd)
    t_gen = time.perf_counter() - t0
    runs = []
    totals = {"vote": 0, "vote_full": 0, "vote_window": 0,
              "upload_score": 0, "upload_unpack": 0, "score_map": 0,
              "refsrc": 0}
    largest = {"sum_counts": -1}
    t0 = time.perf_counter()
    guards = {"counterpart_calls": 0, "upload_score_calls": 0,
              "plain_calls_inside": 0}
    for name, case in gc.CASES.items():
        golden = gc.load_golden(name)
        for route in case.routes:
            rec = (name, route) == ("defaults_noumi", "default")
            with _no_plain_on_card(torch) as guard, \
                    (_patched(vote, "pallas_vote_window",
                              _window_recorder(np, vote, largest)) if rec
                     else contextlib.nullcontext()):
                _zero_counters(vote)
                t = time.perf_counter()
                got = gc.run_route(case, route, wd, device="cuda")
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                launches = _counters(vote)
            run = {"case": name, "route": route, "run_s": dt,
                   "io_line": got["io_line"],
                   "records_out": got["output"]["records"],
                   "kernel_launches": launches,
                   "summary": got["summary"],
                   "differences": gc.differences(got, golden)}
            if got["summary"] != golden["summary"]:
                run["differences"].append("summary")
            runs.append(run)
            for k in totals:
                totals[k] += launches[k]
            for k in guards:
                guards[k] += guard[k]
            if guard["plain_calls_inside"]:
                fail(9, f"{name} on route {route}: a plain version ran inside "
                        f"a Pallas counterpart: {guard}")
            if run["differences"] or not any(launches.values()):
                emit({"phase": 9, "ok": False, **run})
                fail(9, f"{name} on route {route} differs from its golden "
                        f"digests ({run['differences']}) or launched no "
                        "vote kernel")
    t_runs = time.perf_counter() - t0
    if largest["sum_counts"] < 0:
        fail(9, "defaults_noumi launched no window vote to replay")
    _guard_ok(9, guards)
    mats, _srcs, _qtable, _ca, kw, w_mism, w_err = _replay_window(
        torch, largest, 9)
    N, L = mats[0].shape
    if L != 128:
        fail(9, f"defaults_noumi's window launch has L={L}, not 128")
    K, J = kw["classes"][0]
    args, gkw = _gathered_args(np, _vote_inputs(np, K, J, L, N, 128), 128,
                               "sparse_qtable")
    gpu = [None if a is None else torch.from_numpy(a).cuda() for a in args]
    got = vote.vote_gathered(*gpu, **gkw)
    torch.cuda.synchronize()
    want = vote.vote_gathered_plain(*[None if a is None else a.cpu()
                                      for a in gpu], **gkw)
    c_mism, c_err = _compare(got, want)
    if c_mism:
        fail(9, f"gathered kernel != plain twin at L=128 (K={K}, J={J}, "
                f"N={N}): {c_mism} mismatches")
    res = {"phase": 9, "name": "case matrix (tools/golden_compare.py) on "
                               "cuda vs golden digests", "ok": True,
           "cases": len(gc.CASES), "runs": len(runs),
           "duplex_consensus_reads": {
               r["case"]: r["summary"]["duplex_consensus_sequence"]
               for r in runs if r["summary"]["duplex_consensus_sequence"]},
           "generate_s": t_gen, "runs_s": t_runs,
           "kernel_launches": totals, "plain_guard": guards,
           "gathered_cases": sorted({r["case"] for r in runs
                                     if r["kernel_launches"]["vote"]}),
           "L128": {"window_launch_K_J_sumcounts": largest["classes"],
                    "N": N, "L": L, "vote_window_mismatches": w_mism,
                    "vote_window_max_abs_err": w_err,
                    "gathered_shape": {"K": K, "J": J, "N": N},
                    "gathered_mismatches": c_mism,
                    "gathered_max_abs_err": c_err,
                    "tolerance": "exact (0 mismatches)"},
           "per_run": runs}
    emit(res)
    return res


def host_steps(bam, fa, n_shards, shard_ids, out_dir, device):
    """The steps of parallel/multihost.run_host in its order, each timed on
    its own, for one host process (phase 10 runs it in a fresh interpreter
    pinned to one core); prints one JSON line {"steps": [[name, s], ...],
    "timed_s": the sum of the steps that run_host's timer covers, ...}.
    The two imports come before that timer, as in a host process; the
    library loads and the first CUDA call, which run_host makes inside its
    first engine run, are taken apart here so that each has its own time.
    Each shard's engine stages (StageTimer sums) are printed beside it,
    and its window's upload staging (`_window_upload`) with the
    upload-and-score kernel's launches in its eng.run."""
    mark = [time.perf_counter()]
    steps = []

    def lap(name):
        now = time.perf_counter()
        steps.append([name, now - mark[0]])
        mark[0] = now

    import torch
    lap("import torch")
    import pickle

    import numpy as np

    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.engine import VectorEngine
    from gencore_tpu_torch.io import bam as bamio
    from gencore_tpu_torch.io import native
    from gencore_tpu_torch.io.fasta import FastaRef
    from gencore_tpu_torch.options import Options
    from gencore_tpu_torch.parallel import windows
    lap("import the port's modules")
    n_untimed = len(steps)
    if device != "cpu":
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        lap("first CUDA call (context)")
        vote.build_library()
        lap("kernel library load")
    native.get_lib()
    lap("native core load")
    opt = Options(umi_prefix="UMI")
    fasta = FastaRef.load(fa)
    lap("FastaRef.load")
    reader = bamio.BamReader(bam)
    batch = reader.read_all()
    header = reader.header
    lap("read_all")
    windows.resolve_umi_prefix(opt, batch)
    ck = windows.global_checkpoint(batch)
    wm = windows.global_watermark(batch, header.lengths)
    kind, shard = windows.shard_of_reads(batch, header.lengths, n_shards)
    lap("shard keys")
    from gencore_tpu_torch.core import kernels
    stages = {}
    uploads = {}
    os.makedirs(out_dir, exist_ok=True)
    for s in shard_ids:
        sub = windows.subset_batch(batch,
                                   np.nonzero((kind > 0) & (shard == s))[0])
        eng = VectorEngine(opt, header, fasta=fasta, device=device)
        lap(f"shard {s}: subset and engine construction")
        n0 = kernels.UPLOAD_SCORE_LAUNCHES
        table = eng.run(sub, checkpoint=ck, watermark=wm,
                        count_pre_reads=False)
        if device != "cpu":
            torch.cuda.synchronize()
        lap(f"shard {s}: eng.run")
        uploads[s] = {**(_window_upload(eng.work) if hasattr(eng, "work")
                         else {}), "upload_score_launches":
                      kernels.UPLOAD_SCORE_LAUNCHES - n0}
        stages[s] = {k: round(v, 4) for k, v in sorted(
            eng.timer.totals.items(), key=lambda kv: -kv[1])[:8]}
        stem = os.path.join(out_dir, f"shard_{s}")
        table.build_payload().tofile(stem + ".payload")
        np.save(stem + ".keys.npy", table.record_keys())
        with open(stem + ".stats.pkl", "wb") as f:
            pickle.dump((eng.pre_stats, eng.post_stats), f)
        lap(f"shard {s}: payload, keys and stats files")
    print(json.dumps({"steps": steps,
                      "timed_s": sum(t for _, t in steps[n_untimed:]),
                      "reads": int(batch.n), "shards": list(shard_ids),
                      "device": device, "torch_threads":
                      torch.get_num_threads(), "eng_stages": stages,
                      "eng_uploads": uploads}),
          flush=True)


def _pinned_host_steps(bam, fa, out_dir, core):
    """host_steps for one host that runs both shards of two, in a fresh
    interpreter pinned to `core` on cuda:0; returns its JSON line."""
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "chip_smoke.host_steps(%r, %r, 2, [0, 1], %r, 'cuda:0')"
            % (REPO, bam, fa, out_dir))
    r = subprocess.run(["taskset", "-c", str(core), sys.executable, "-c",
                        code], capture_output=True, text=True, timeout=600,
                       cwd=REPO)
    if r.returncode != 0:
        fail(10, f"the pinned host-steps driver failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_entry(torch):
    """10: entry() on the card against kernels.consensus_plain on the same
    inputs (exact), then dryrun_multichip(1) on cuda:0 with its pinned
    2-host run (two processes on one card, one core each) under
    _no_plain_on_card, each window's upload staging recorded (a sparse
    window must launch upload_score once), then one more pinned host of
    both shards through host_steps, which times each step of run_host on
    its own (printed on its own line; each sparse shard window must
    launch upload_score once)."""
    from gencore_tpu_torch import entry
    from gencore_tpu_torch.core import kernels, vote
    fn, args = entry.entry("cuda")
    _zero_counters(vote)
    got = fn(*args)
    torch.cuda.synchronize()
    launches = _counters(vote)
    want = kernels.consensus_plain(*[a.cpu() for a in args], **entry.VOTE_KW)
    mism = sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
    err = max(int((g.cpu().long() - w.long()).abs().max())
              for g, w in zip(got, want))
    if mism or launches["vote_full"] != 1:
        fail(10, f"entry() differs from consensus_plain ({mism} mismatches) "
                 f"or did not launch the Bins16 kernel once: {launches}")
    wd = os.path.join(WORK, "hosts")
    os.makedirs(wd, exist_ok=True)
    t0 = time.perf_counter()
    workload = entry._dryrun_workload(27000, wd)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    with _window_uploads() as windows, _no_plain_on_card(torch) as guard:
        _zero_counters(vote)
        dry = entry.dryrun_multichip(1, device="cuda:0", busy_reps=2,
                                     workload=workload)
        dry_launches = _counters(vote)
    t_dry = time.perf_counter() - t0
    if dry["pinned_efficiency"] is None or not dry_launches["vote_window"]:
        fail(10, "dryrun_multichip(1) skipped its pinned 2-host run or "
                 "launched no window vote")
    _guard_ok(10, guard)
    sparse = [x for x in windows if x["mode"] == "sparse"]
    if dry_launches["upload_score"] != len(sparse):
        fail(10, f"dryrun_multichip(1) made {len(sparse)} sparse windows but "
                 f"launched upload_score {dry_launches['upload_score']} "
                 "times")
    steps = _pinned_host_steps(*workload, os.path.join(wd, "steps"),
                               sorted(os.sched_getaffinity(0))[0])
    emit({"phase": 10, "name": "run_host's steps, one host of both shards "
                               "pinned to one core on cuda:0", **steps})
    bad = {s: u for s, u in steps["eng_uploads"].items()
           if u.get("upload_score_launches") != (u.get("mode") == "sparse")}
    if bad:
        fail(10, f"a pinned host's sparse shard window did not launch "
                 f"upload_score once (or a dense one did): {bad}")
    res = {"phase": 10, "name": "entry() vs consensus_plain; "
                                "dryrun_multichip(1) on cuda:0", "ok": True,
           "entry": {"shape": list(args[0].shape), "mismatches": mism,
                     "max_abs_err": err, "kernel_launches": launches,
                     "tolerance": "exact (0 mismatches)"},
           "dryrun": dry, "dryrun_s": t_dry, "generate_s": t_gen,
           "dryrun_windows": [dict(w, count=windows.count(w)) for w in
                              {json.dumps(x, sort_keys=True): x
                               for x in windows}.values()],
           "dryrun_plain_guard": guard,
           "host_steps_timed_s": steps["timed_s"],
           "dryrun_kernel_launches_in_process": dry_launches}
    emit(res)
    return res


def phase_rss(torch):
    """11: tools/measure_rss.py at scale 1 and 2 on cuda: host (peak
    resident set, tracemalloc, glibc heap, pinned host pool) and device
    residency of the in-memory window pipeline and of the streaming path,
    each in a fresh process; the two outputs must hold the same records.
    Also the streaming path's growth from scale 1 to 2: peak resident
    set, its traced part and the rest."""
    from gencore_tpu_torch.tools import measure_rss
    scales = []
    for scale in (1, 2):
        t0 = time.perf_counter()
        r = measure_rss.measure(scale, device="cuda",
                                workdir=os.path.join(WORK, "workloads"))
        r["measure_s"] = time.perf_counter() - t0
        scales.append(r)
        if not r["outputs_identical"]:
            fail(11, f"measure_rss at scale {scale}: the in-memory and the "
                     "streaming outputs differ")
    s1, s2 = scales

    def ratio(key):
        return (s2[key] / s1[key] if s1.get(key) and s2.get(key) is not None
                else "not measured")

    def growth(mode, key):
        a, b = s1.get(f"{mode}_{key}"), s2.get(f"{mode}_{key}")
        return None if a is None or b is None else b - a

    def pinned(r):
        hp = r.get("streaming_host_pinned")
        return None if hp is None else {
            "bytes": hp.get("allocated_bytes.current"),
            "peak_bytes": hp.get("allocated_bytes.peak"),
            "blocks": hp.get("allocations.current")}

    # the streaming path's growth from scale 1 to 2, split into what
    # tracemalloc sees and the rest, beside the pinned host pool and the
    # glibc heap that could hold the rest
    rss_g = growth("streaming", "peak_rss_mb")
    traced_g = growth("streaming", "tracemalloc_peak_mb")
    heap = [r.get("streaming_malloc_end_mb") or {} for r in (s1, s2)]
    res_growth = {
        "peak_rss_mb": rss_g, "tracemalloc_peak_mb": traced_g,
        "untraced_mb": (None if rss_g is None or traced_g is None
                        else rss_g - traced_g),
        "malloc_free_in_arenas_end_mb": (
            heap[1]["free_in_arenas"] - heap[0]["free_in_arenas"]
            if heap[0] and heap[1] else None),
        "pinned_host_pool": [pinned(r) for r in scales]}
    res = {"phase": 11, "name": "measure_rss, in-memory vs streaming, "
                                "scale 1 and 2", "ok": True,
           "streaming_growth_scale_1_to_2": res_growth,
           "ratios_scale_2_to_1": {
               f"{mode}_{k}": ratio(f"{mode}_{k}")
               for mode in ("in_memory", "streaming")
               for k in ("peak_rss_mb", "sampled_rss_peak_mb",
                         "tracemalloc_peak_mb", "cuda_max_allocated_mb",
                         "cuda_max_reserved_mb")},
           "scales": scales}
    emit(res)
    return res


def phase_tsan():
    """12: the port's native core (csrc/gcio.cpp behind gcio_codec.h) with
    the zlib codec, the build this card's CLI runs, linked with its
    exerciser csrc/test_gcio.cpp under ThreadSanitizer
    (io/native.build_tsan) and run: fails on a nonzero exit or a race
    report. Where the compiler refuses -fsanitize=thread, prints the
    refusal on its own line and goes on."""
    from gencore_tpu_torch.io import native
    t0 = time.perf_counter()
    try:
        exe = native.build_tsan("zlib")
    except native.NativeCoreError as e:
        print("tsan: the zlib build was refused here: "
              + " ".join(str(e).split()), flush=True)
        emit({"phase": 12, "name": "native core under ThreadSanitizer "
                                   "(zlib)", "ok": True, "built": False})
        return
    t_build = time.perf_counter() - t0
    d = os.path.join(WORK, "tsan")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([exe, d], capture_output=True, text=True, timeout=300)
    races = r.stderr.count("WARNING: ThreadSanitizer")
    if r.returncode != 0 or races:
        fail(12, f"the TSan exerciser exited {r.returncode} with {races} "
                 f"race report(s): {r.stderr[-3000:]}")
    emit({"phase": 12, "name": "native core under ThreadSanitizer (zlib)",
          "ok": True, "built": True, "build_s": t_build,
          "run_s": time.perf_counter() - t0, "races": 0,
          "stdout": r.stdout.strip(),
          "program": os.path.relpath(exe, REPO)})


def _dense_line(kind, lr, single, cases, cases_in, dense):
    """The kernels line's entry of one csrc/upload_dense.cu kernel: its
    launches in phase 7b (the long-read panel on the default streaming
    path), 4d and 9, and its times at 7b's largest call."""
    t = lr[f"{kind}_largest"]
    return {
        "name": kind, "route": "cuda",
        "source": "gencore_tpu_torch/csrc/upload_dense.cu",
        "replaces": {"upload_unpack": "gencore_tpu/engine.py:2883",
                     "score_map": "gencore_tpu/core/kernels.py:310"}[kind],
        "replaces_what": {
            "upload_unpack": "_upload_unpack_fn, the XLA program K12 of "
                             "the dense staging route; no Pallas kernel",
            "score_map": "score_map_kernel and :373 "
                         "score_map_kernel_packed, the XLA program K5 of "
                         "the dense staging route; no Pallas kernel"}[kind],
        "redesigned": True,
        "design": {
            "upload_unpack": "a thread per four tasks of 16 positions, "
                             "the staging read in aligned words and "
                             "decoded a byte at a time through shared "
                             "tables, 16-byte stores",
            "score_map": "a warp per batch of rows, a mate pair taken "
                         "once by the warp of its lower row, the mate's "
                         "granules shifted into place, four positions "
                         "per word, 16-byte stores"}[kind],
        "launches": lr["kernel_launches"][kind],
        "launches_in": "phase 7b, the long_amplicon panel on the default "
                       "streaming path (every window dense)",
        "launches_single_shot": single["kernel_launches"][kind],
        "launches_single_shot_in": "phase 4d, the deep panel with "
                                   "--windows 1",
        "launches_cases": cases["kernel_launches"][kind],
        "launches_cases_in": cases_in,
        "max_abs_err": max(t["max_abs_err"], dense["max_abs_err"]),
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "share_of_bound": t["share_of_bound"], "library_ms": None,
        "shape": f"phase 7b, the run's largest call: {t['rows']} rows, "
                 f"L={t['L']}, {t['modes']}",
        "phase_2f": [{k: r[k] for k in ("rows", "L", "ms", "call_ms",
                                        "plain_ms", "bound_ms",
                                        "share_of_bound") if k in r}
                     for r in dense[kind] if "ms" in r]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np
    sys.path.insert(0, REPO)
    os.makedirs(WORK, exist_ok=True)
    t_start = time.perf_counter()
    card = phase_env(torch)
    phase_build()
    vk = phase_vote_kernel(torch, np)
    win_err = phase_window_kernel(torch, np)
    ups = phase_upload_score(torch, np)
    dense = phase_dense(torch, np)
    piles = phase_deep_piles(torch, np)
    full = phase_full_kernel(torch, np)
    small = phase_small(torch, np)
    full_bins = phase_full_bins(torch)
    bam, fa, golden, launches, largest = phase_full(torch, np)
    shard_runs = phase_shards(torch, bam, fa, golden)
    mem_runs = phase_in_memory(torch, bam, fa, golden)
    single = phase_single_shot(torch, bam, fa, golden)
    rep = phase_replay(torch, np, largest)
    ud, ud_wl = phase_ultradeep(torch, np)
    lr, lr_wl = phase_long_reads(torch, np)
    phase_busy(torch, np, [
        ("deep_panel", bam, fa, golden, [], True),
        ("deep_panel_windows1", bam, fa, golden, ["--windows", "1"], False),
        ("ultradeep", *ud_wl, [], True),
        ("long_amplicon", *lr_wl, [], True)])
    mesh_res = phase_mesh(torch, np)
    t9 = time.perf_counter()
    cases = phase_cases(torch, np)
    ent = phase_entry(torch)
    phase_rss(torch)
    t_new = time.perf_counter() - t9
    phase_tsan()
    cases_in = (f"phase 9, {cases['cases']} CLI cases on every route each "
                f"allows ({cases['runs']} runs), counters zeroed before "
                "each run and summed")
    pile = next(p for p in piles if (p["J"], p["K"]) == DEEP_TIMED)
    n_bytes = sum(p["bytes"] for p in full)
    n_ops = sum(p["int_ops"] for p in full)
    full_bound, full_by = bound(n_bytes, n_ops)
    emit({"kernels": [
        {"name": "vote_window", "route": "cuda",
         "source": "gencore_tpu_torch/csrc/vote_window.cu",
         "replaces": "gencore_tpu/core/pallas_vote.py:390",
         "launches": launches["vote_window"],
         "launches_in": "phase 4, the deep panel on the streaming path",
         "launches_sharded": [r["kernel_launches"]["vote_window"]
                              for r in shard_runs],
         "launches_sharded_in": "phase 4b, --shards 4 and its resume",
         "launches_in_memory": [r["kernel_launches"]["vote_window"]
                                for r in mem_runs.values()],
         "launches_in_memory_in": "phase 4c, the in-memory window pipeline "
                                  "with and without the native core",
         "launches_cases": cases["kernel_launches"]["vote_window"],
         "launches_cases_in": cases_in,
         "max_abs_err": max(win_err, rep["max_abs_err"]),
         "ms": rep["ms"], "call_ms": rep["call_ms"],
         "plain_ms": rep["plain_ms"],
         "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
         "library_ms": None,
         "shape": f"the deep panel's largest window launch: classes "
                  f"(K, J, sum counts) {rep['classes_K_J_sumcounts']}, "
                  f"N={rep['N']}, L={rep['L']}"},
        {"name": "vote", "route": "cuda",
         "source": "gencore_tpu_torch/csrc/vote.cu (gc_vote_epilogue: "
                   "Bins6 with the epilogue of csrc/epilogue.cuh)",
         "replaces": "gencore_tpu/core/pallas_vote.py:474",
         "also_replaces": ["gencore_tpu/core/pallas_vote.py:350 "
                           "(pallas_vote)",
                           "gencore_tpu/core/pallas_vote.py:178 "
                           "(_pallas_core)",
                           "gencore_tpu/core/pallas_vote.py:229 "
                           "(_epilogue_core)"],
         "launches": ud["kernel_launches"]["vote"],
         "launches_in": "phase 7, the ultra-deep pile (gathered path)",
         "launches_cases": cases["kernel_launches"]["vote"],
         "launches_cases_in": cases_in,
         "max_abs_err": max(vk["max_abs_err"],
                            max(p["max_abs_err"] for p in piles)),
         "ms": pile["ms"], "call_ms": pile["call_ms"],
         "plain_ms": pile["plain_ms"],
         "bound_ms": pile["bound_ms"], "bound_by": pile["bound_by"],
         "library_ms": None,
         "vote_alone_ms": pile["vote_only_ms"],
         "pallas_vote": {
             "launches": small["kernel_launches"]["vote"],
             "shifted_calls": small["entry_calls"]["pallas_vote"],
             "launches_in": "phase 3, the small panel: the gathered "
                            "launches, of which shifted_calls vote "
                            "lenDiff-shifted members (pallas_vote, "
                            "gencore_tpu/core/pallas_vote.py:350)",
             **{k: small["shifted_call"][k] for k in (
                 "K", "S", "L", "refsrc", "ms", "call_ms", "plain_ms",
                 "bound_ms", "bound_by", "share_of_bound")}},
         "replaced_composition_call_ms": pile["composition_call_ms"],
         "shape": f"phase 2c, J={pile['J']}, K={pile['K']}, L={pile['L']}, "
                  f"split {pile['split']}, sparse with a qual table; phase "
                  f"2a sum over K in {list(K_CLASSES)} at J={J_PHASE2}: "
                  f"{vk['ms']} ms"},
        {"name": "vote (16 bins)", "route": "cuda",
         "source": "gencore_tpu_torch/csrc/vote.cu (Bins16)",
         "replaces": "gencore_tpu/core/kernels.py:421 (fused_vote_kernel, "
                     "the XLA program K9; no Pallas kernel)",
         "launches": full_bins["vote_full"],
         "launches_in": "phase 3b, the full-bins panel",
         "launches_mesh": sum(r["kernel_launches"]["vote_full"]
                              for r in mesh_res.values()),
         "launches_mesh_in": "phase 8, mesh.sharded_consensus_step (K14)",
         "launches_cases": cases["kernel_launches"]["vote_full"],
         "launches_cases_in": cases_in,
         "max_abs_err": max(p["max_abs_err"] for p in full),
         "ms": sum(p["ms"] for p in full),
         "call_ms": sum(p["call_ms"] for p in full),
         "plain_ms": sum(p["plain_ms"] for p in full),
         "bound_ms": full_bound, "bound_by": full_by, "library_ms": None,
         "shape": f"phase 2d, sum over (J, K) in {list(FULL_SHAPES)}, "
                  f"L={L_PHASE2}"},
        {"name": "upload_score", "route": "cuda",
         "source": "gencore_tpu_torch/csrc/upload_score.cu",
         "replaces": "gencore_tpu/engine.py:3034 (_upload_score_fn, the XLA "
                     "program K4-K6: _upload_sparse_trace :2938, "
                     "kernels.py:373 score_map_kernel_packed; no Pallas "
                     "kernel)",
         "launches": launches["upload_score"],
         "launches_in": "phase 4, the deep panel on the streaming path",
         "launches_sharded": [r["kernel_launches"]["upload_score"]
                              for r in shard_runs],
         "launches_in_memory": [r["kernel_launches"]["upload_score"]
                                for r in mem_runs.values()],
         "launches_ultradeep": ud["kernel_launches"]["upload_score"],
         "launches_cases": cases["kernel_launches"]["upload_score"],
         "launches_cases_in": cases_in,
         "launches_dryrun": ent["dryrun_kernel_launches_in_process"][
             "upload_score"],
         "launches_dryrun_in": "phase 10, dryrun_multichip(1) in process: "
                               "windows of more than 65,536 rows",
         "max_abs_err": max(ups["max_abs_err"],
                            rep["upload_score"]["max_abs_err"]),
         "ms": rep["upload_score"]["ms"],
         "host_ms": rep["upload_score"]["host_ms"],
         "call_ms": rep["upload_score"]["call_ms"],
         "plain_ms": rep["upload_score"]["plain_ms"],
         "bound_ms": rep["upload_score"]["bound_ms"],
         "bound_by": rep["upload_score"]["bound_by"], "library_ms": None,
         "share_of_bound": rep["upload_score"]["share_of_bound"],
         "shape": f"phase 5, the deep panel's largest deferred upload: "
                  f"n={rep['upload_score']['n']}, "
                  f"w={rep['upload_score']['w']}, "
                  f"L={rep['upload_score']['L']}",
         "u32_ms": ups["upload_score_u32"][0]["ms"],
         "u32_bound_ms": ups["upload_score_u32"][0]["bound_ms"],
         "u32_shape": f"phase 2e, {N_UPLOAD32} rows with u32 mate rows, "
                      "the deep panel's flags"},
        {"name": "refbase (read in vote.cu)", "route": "cuda",
         "source": "gencore_tpu_torch/csrc/vote.cu (gc_vote_epilogue given "
                   "the window's refbase sources: JobRef, and row_of of "
                   "csrc/refbase.cuh, shared with vote_window.cu)",
         "replaces": "gencore_tpu/engine.py:3097 (_refbase_combine_fn, the "
                     "XLA program K11, and the row gather of its result, "
                     "engine.py:1828; no Pallas kernel)",
         "launches": ud["kernel_launches"]["refsrc"],
         "launches_in": "phase 7, the ultra-deep pile: its gathered votes "
                        "reading the window's refbase sources",
         "launches_long_amplicon": lr["kernel_launches"]["refsrc"],
         "launches_long_amplicon_in": "phase 7b",
         "launches_cases": cases["kernel_launches"]["refsrc"],
         "launches_cases_in": cases_in,
         "max_abs_err": max(r["max_abs_err"] for r in
                            ups["refbase"] + ud["gathered_launches"]
                            + [lr["gathered_largest"]]),
         "ms": ud["refsrc_largest"]["ms"],
         "ms_rows_form": ud["refsrc_largest"]["ms_rows_form"],
         "host_ms": ud["refsrc_largest"]["host_ms"],
         "call_ms": ud["refsrc_largest"]["call_ms"],
         "plain_ms": ud["refsrc_largest"]["plain_ms"],
         "bound_ms": ud["refsrc_largest"]["bound_ms"],
         "bound_by": ud["refsrc_largest"]["bound_by"], "library_ms": None,
         "share_of_bound": ud["refsrc_largest"]["share_of_bound"],
         "shape": f"phase 7, the ultra-deep run's gathered launch of the "
                  f"most jobs: K={ud['refsrc_largest']['K']}, "
                  f"J={ud['refsrc_largest']['J']}, "
                  f"L={ud['refsrc_largest']['L']}; ms is the whole "
                  "launch's (vote, epilogue and refbase read), "
                  "ms_rows_form the same launch given its refbase rows, "
                  "plain_ms refbase_combine, the row gather and the plain "
                  "vote",
         "phase_2e": [{k: r[k] for k in ("J", "K", "L", "ms", "ms_in_turns",
                                         "call_ms", "host_ms", "plain_ms",
                                         "bound_ms", "share_of_bound")}
                      for r in ups["refbase"]],
         "long_amplicon_largest": {k: lr["gathered_largest"][k] for k in (
             "K", "J", "L", "split", "ms", "ms_rows_form", "plain_ms",
             "bound_ms", "share_of_bound")}},
        *[_dense_line(kind, lr, single, cases, cases_in, dense)
          for kind in ("upload_unpack", "score_map")]],
        "seconds": time.perf_counter() - t_start,
        "seconds_phases_9_to_11": t_new})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
