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
      2a gc_vote (csrc/vote.cu, Bins6) against vote_core_plain at J=4096,
         L=160, N=40960 for every k-class K in {4, 16, 32, 64, 128, 256};
      2b gc_vote_window (csrc/vote_window.cu) against vote_window_plain at
         the same shapes, member counts 0..K, job lengths <= L, out_len =
         L and 136, with and without a qual table;
      2c gc_vote at the deep-pile shapes J in {8, 32, 128}, K in {512,
         2048, 4096}, L=160 (disjoint member groups, K/2 < count <= K),
         with the CTAs per job (split) each launch used;
      2d gc_vote_full (csrc/vote.cu, Bins16: kernels.fused_vote_kernel on
         CUDA tensors) against kernels.fused_vote_plain on the card, all 16
         nt16 codes, lenDiff shifts, job lengths <= L;
    with each kernel's device time (vote_window: torch.profiler; vote.cu:
    CUDA events around each call with the stream kept busy ahead of them)
    and its wrapper's time per call, its plain version's time per call on
    the card (CUDA events,
    in turns plain, kernel, kernel, plain) where the kernels line needs
    it, its bound and its share of the bound;
  3 a ~3k-read workload (duplex UMIs, deep clusters, lenDiff-shifted right
    reads) through the port's CLI on cuda, against the scalar oracle:
    records and report stats equal, and both kernels launched (the window
    path and the gathered paths);
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
  4b the same input with `--shards 4 --checkpoint_dir D`, then again after
    one shard's files were deleted from D (resume): both equal to the
    golden digests, the second run recomputing exactly that shard;
  4c the same input through the in-memory window pipeline
    (parallel/pipeline.run_pipelined, `--windows 5` under
    GENCORE_NO_STREAM, the CLI's path for what it does not stream): once
    with the native core, each window written as it retires, and once as
    on a machine without the core (pure-Python codec, windows merged into
    one payload); both equal to the golden digests, window votes launched;
  5 the deep panel's largest window launch, replayed: the fused kernel
    against its twin (exact) and timed against the plain composition on
    the card, with its bound;
  6 device busy time and launch count of one deep-panel run (torch.profiler)
    before, with the plain composition put back for that run only
    (vote_window_plain on CUDA tensors: csrc/vote.cu plus the plain-torch
    epilogue and concat), and after, with the fused kernel; both must take
    the streaming path;
  7 the ultra-deep pile (workloads.ultradeep: 40 loci x 1,500 pairs, UMI
    grouping off) through the CLI on cuda, which must take the streaming
    path, against its golden digests: wall
    seconds and reads/s, then a profiled run with each gathered vote
    launch's (K, J), split, device time and share of its bound;
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
    window launch replayed, and vote_core on inputs of its shape;
 10 entry.entry() on the card against kernels.consensus_plain (exact), and
    entry.dryrun_multichip(1) on cuda:0: 1-device records, stats_psum
    against the host merge, the window plan and the busy-time rebalance,
    and two host processes pinned to cores 0 and 1 on the one card; then
    one more pinned host of both shards through host_steps, which times
    each step of multihost.run_host on its own (torch import, first CUDA
    call, library loads, FASTA load, read_all, shard keys, and per shard
    the engine construction, eng.run and the files), on its own line;
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
over 3.35 TB/s, and ~10 int32 operations per (valid member, position) over
16.7 T op/s (132 SMs x 64 INT32 lanes x 1.98 GHz); the larger one binds.

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
        name = ("vote_window" if "vote_window" in fn else
                "vote (16 bins)" if "Bins16" in fn else "vote")
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
    if name == "vote_window_kernel":   # the kernel alone, as in PR 2
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


def phase_vote_kernel(torch, np):
    from gencore_tpu_torch.core import vote
    dev = torch.device("cuda", 0)
    J, L, N = J_PHASE2, L_PHASE2, N_PHASE2
    th = dict(hi=KW["hi"], mod=KW["mod"], lo=KW["lo"],
              bsr=KW["base_score_req"], rnum=KW["ratio_num"],
              rden=KW["ratio_den"])
    per_k = []
    worst = 0
    for K in K_CLASSES:
        arrs = _vote_inputs(np, K, J, L, N, K)
        cpu = [torch.from_numpy(a) for a in arrs]
        gpu = [t.to(dev) for t in cpu]
        got = vote.vote_core(*gpu, **KW)
        torch.cuda.synchronize(dev)
        want = vote.vote_core_plain(*cpu, **th)
        mism = sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
        err = max(int((g.cpu().long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        worst = max(worst, err)
        t = _timings(torch, lambda: vote.vote_core_plain(*gpu, **th),
                     lambda: vote.vote_core(*gpu, **KW), "vote_kernel", 2, 20)
        n_bytes, n_ops = _vote_bound(np, arrs[3], arrs[4], K, J, L)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_k.append({"K": K, "J": J, "L": L, "N": N, "mismatches": mism,
                      "max_abs_err": err, **t, "bytes": n_bytes,
                      "int_ops": n_ops, "bound_ms": b_ms, "bound_by": b_by,
                      "share_of_bound": b_ms / t["ms"]})
        if mism:
            fail("2a", f"vote kernel != plain twin at K={K}: {mism} "
                       "mismatches")
    emit({"phase": "2a", "name": "gc_vote vs vote_core_plain", "ok": True,
          "tolerance": "exact (0 mismatches)", "per_k": per_k})
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


def _vote_bound(np, rows, valid, K, J, L):
    """(bytes, int ops) of a vote over these members: each valid member
    row read once, the row indices, flags and refbase read once, four
    int32 [J, L] outputs written once; 10 ops per (valid member,
    position)."""
    v = valid.astype(bool)
    n_rows = len(np.unique(rows[v]))
    n_bytes = n_rows * 3 * L + K * J * 5 + J * L + 16 * J * L
    return n_bytes, OPS_PER_MEMBER_POS * int(v.sum()) * L


def phase_deep_piles(torch, np):
    """2c: gc_vote at the deep-pile shapes against vote_core_plain (on the
    card), with its device time, bound and share."""
    from gencore_tpu_torch.core import vote
    dev = torch.device("cuda", 0)
    th = dict(hi=KW["hi"], mod=KW["mod"], lo=KW["lo"],
              bsr=KW["base_score_req"], rnum=KW["ratio_num"],
              rden=KW["ratio_den"])
    per_shape = []
    for J, K in DEEP_SHAPES:
        arrs = _pile_inputs(np, K, J, L_PHASE2, J + K)
        gpu = [torch.from_numpy(a).to(dev) for a in arrs]
        got = vote.vote_core(*gpu, **KW)
        want = vote.vote_core_plain(*gpu, **th)
        torch.cuda.synchronize(dev)
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        if mism:
            fail("2c", f"vote kernel != plain twin at J={J}, K={K}: {mism} "
                       "mismatches")
        if (J, K) == DEEP_TIMED:   # the ultradeep run's shape: with plain
            t = _timings(torch, lambda: vote.vote_core_plain(*gpu, **th),
                         lambda: vote.vote_core(*gpu, **KW), "vote_kernel",
                         1, 5, profile_plain=False)
        else:
            t = {"ms": _kernel_ms(torch, lambda: vote.vote_core(*gpu, **KW)),
                 "call_ms": _time_ms(torch,
                                     lambda: vote.vote_core(*gpu, **KW), 5)}
        ms = t["ms"]
        n_bytes, n_ops = _vote_bound(np, arrs[3], arrs[4], K, J, L_PHASE2)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_shape.append({"J": J, "K": K, "L": L_PHASE2, "N": len(arrs[0]),
                          "split": vote.split_size(K, J),
                          "members": int(arrs[4].sum()), "mismatches": mism,
                          "max_abs_err": err, **t,
                          "bytes": n_bytes, "int_ops": n_ops,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "share_of_bound": b_ms / ms})
        del gpu, got, want
    emit({"phase": "2c", "name": "gc_vote at deep-pile shapes vs "
                                 "vote_core_plain", "ok": True,
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


def _window_bound(np, class_args, classes, N, L, Jw, out_len, qtable):
    """(bytes, int ops) the fused window kernel must move and do on these
    inputs: every member row, template row of an empty job and refbase row
    read once, the job table and qual table, the wire buffer and the
    dense fallback written once; 10 ops per (member, position)."""
    from gencore_tpu_torch.core import vote
    member = np.zeros(N, dtype=bool)
    tmpl = np.zeros(N, dtype=bool)
    refrows = np.zeros(Jw, dtype=bool)
    n_members = 0
    Jt = 0
    for ci, (K, J) in enumerate(classes):
        base, counts, _jl, ridx = (np.asarray(a).astype(np.int64) for a in
                                   class_args[4 * ci:4 * ci + 4])
        cnt = np.clip(counts, 0, K)
        n_members += int(cnt.sum())
        off = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        member[np.clip(np.repeat(base, cnt) + off, 0, N - 1)] = True
        tmpl[np.clip(base[cnt == 0], 0, N - 1)] = True
        refrows[np.clip(ridx, 0, Jw - 1)] = True
        Jt += J
    ol = min(out_len, L)
    n_bytes = (int(member.sum()) * 3 * L + int((tmpl & ~member).sum()) * 2 * L
               + int(refrows.sum()) * L + 24 * Jt
               + (16 if qtable is not None else 0)
               + vote.wire_size(Jt, len(classes), qtable) + Jt * (ol // 2 + ol))
    return n_bytes, OPS_PER_MEMBER_POS * n_members * L, n_members


def _compare_window(got, want):
    """(mismatching bytes, max abs difference) of two (flat, dense)."""
    pairs = [(got[0], want[0])] + [
        (g, w) for gd, wd in zip(got[1], want[1]) for g, w in zip(gd, wd)]
    mism = 0
    err = 0
    for g, w in pairs:
        g = g.cpu()
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
    Jw = J
    per_k = []
    worst = 0
    for K in K_CLASSES:
        rng = np.random.default_rng(1000 + K)
        seq, qual, score = _matrices(np, rng, L, N)
        refbase = np.array([0, 1, 2, 4, 8], np.uint8)[
            rng.integers(0, 5, size=(Jw, L))]
        refbase[::4] = 0
        class_args = _window_class_args(np, rng, K, J, N, Jw, L)
        classes = ((K, J),)
        qtable = np.zeros(16, dtype=np.uint8)
        qtable[1:7] = [2, 12, 18, 25, 30, 36]      # 41 escapes: bad > 0
        cpu = [torch.from_numpy(a) for a in (seq, qual, score, refbase)]
        gpu = [t.to(dev) for t in cpu]
        variants = []
        for out_len in (L, 136):
            for qt in (None, qtable):
                kw = dict(classes=classes, L=L, out_len=out_len, **KW)
                qc = None if qt is None else torch.from_numpy(qt)
                got = vote.vote_window(*gpu, None if qc is None else
                                       qc.to(dev), class_args, **kw)
                torch.cuda.synchronize(dev)
                want = vote.vote_window_plain(*cpu, qc, class_args, **kw)
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
        qg = torch.from_numpy(qtable).to(dev)
        kw = dict(classes=classes, L=L, out_len=L, **KW)
        t = _timings(
            torch, lambda: vote.vote_window_plain(*gpu, qg, class_args, **kw),
            lambda: vote.vote_window(*gpu, qg, class_args, **kw),
            "vote_window_kernel", 2, 20)
        n_bytes, n_ops, n_members = _window_bound(
            np, class_args, classes, N, L, Jw, L, qtable)
        b_ms, b_by = bound(n_bytes, n_ops)
        per_k.append({"K": K, "J": J, "L": L, "N": N,
                      "sum_counts": n_members, "variants": variants, **t,
                      "bytes": n_bytes, "int_ops": n_ops, "bound_ms": b_ms,
                      "bound_by": b_by, "share_of_bound": b_ms / t["ms"]})
    emit({"phase": "2b", "name": "gc_vote_window vs vote_window_plain",
          "ok": True, "tolerance": "exact (0 mismatching bytes)",
          "plain": "vote_window_plain on CUDA tensors (csrc/vote.cu + "
                   "plain-torch epilogue and concat)",
          "per_k": per_k})
    return worst


def _cli(args):
    """The port's CLI in-process; returns (rc, captured stderr)."""
    from gencore_tpu_torch import cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, err.getvalue()


@contextlib.contextmanager
def _patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def phase_small(torch):
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.tools import workloads
    from gencore_tpu_torch.tools.make_golden import (digest_records,
                                                     digest_report)
    d = os.path.join(WORK, "small")
    bam, fa, n_reads = workloads.small_panel(d)
    calls = {"pallas_vote_window": 0, "pallas_vote_gathered": 0,
             "pallas_vote": 0}
    originals = {k: getattr(vote, k) for k in calls}

    def counted(name):
        def f(*a, **k):
            calls[name] += 1
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
    emit({"phase": 3, "name": "small end to end vs oracle", "ok": ok,
          "reads_in": n_reads, "records_out": p[0],
          "records_equal": p == o, "report_stats_equal": rep_eq,
          "kernel_launches": launches, "entry_calls": calls})
    if not ok:
        fail(3, "port output differs from the oracle, or a vote kernel or "
                "entry point did not run")
    return launches


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


def _io_lines(err):
    """The `I/O: ...` lines of a CLI run's stderr (the CLI prints one)."""
    return [ln for ln in err.splitlines() if ln.startswith("I/O: ")]


def _streaming_line():
    from gencore_tpu_torch.io import native
    return f"I/O: native core ({native.codec()}), streaming path"


def _counters(vote):
    return {"vote": vote.LAUNCHES, "vote_full": vote.FULL_LAUNCHES,
            "vote_window": vote.WINDOW_LAUNCHES}


def _zero_counters(vote):
    vote.LAUNCHES = 0
    vote.FULL_LAUNCHES = 0
    vote.WINDOW_LAUNCHES = 0


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


def phase_ultradeep(torch, np):
    """7: the ultra-deep amplicon pile (bench.make_ultradeep_workload, 40
    loci x 1,500 pairs, UMI grouping off) through the CLI on cuda against
    its golden digests: wall seconds and reads/s of one run, then a run
    that records each gathered vote launch's inputs, replayed for its
    (K, J), split, device time and share of its bound."""
    from gencore_tpu_torch.core import vote
    bam, fa, golden, n_in, t_gen = _golden_workload("ultradeep", 7)
    _zero_counters(vote)
    rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
        torch, bam, fa, os.path.join(WORK, "ultradeep"), golden)
    launches = _counters(vote)
    if rc or not (out_ok and rep_ok) or launches["vote"] == 0:
        fail(7, f"ultradeep run failed, differs from the golden digests, or "
                f"launched no gathered vote: rc={rc} {launches} {err[-1500:]}")
    io_lines = _io_lines(err)
    if io_lines != [_streaming_line()]:
        fail(7, f"the ultradeep run did not take the streaming path on the "
                f"native core: {io_lines}")
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[stage\] (\S+): ([0-9.]+)s", err)}

    # a second run records each gathered launch's inputs, replayed after
    calls = []
    orig = vote.vote_core

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        calls.append(([t.clone() for t in args], dict(kw)))
        return out

    with _patched(vote, "vote_core", recorded):
        rc, err, t_rec, _n, out_ok2, rep_ok2 = _deep_panel_run(
            torch, bam, fa, os.path.join(WORK, "ultradeep_rec"), golden)
    if rc or not (out_ok2 and rep_ok2) or _io_lines(err) != io_lines:
        fail(7, f"recorded ultradeep run failed, differs or took another "
                f"path: rc={rc} {_io_lines(err)}")
    per_launch = []
    for args, kw in calls:
        K, J = args[3].shape
        ms = _kernel_ms(torch, lambda: vote.vote_core(*args, **kw))
        r = args[3].cpu().numpy()
        v = args[4].cpu().numpy()
        b_ms, b_by = bound(*_vote_bound(np, r, v, K, J, args[0].shape[1]))
        per_launch.append({"K": K, "J": J,
                           "members": int(v.astype(bool).sum()),
                           "split": vote.split_size(K, J), "ms": ms,
                           "bound_ms": b_ms,
                           "bound_by": b_by, "share_of_bound": b_ms / ms})
    del calls
    res = {"phase": 7, "name": "ultra-deep pile vs golden", "ok": True,
           "workload": golden["workload"], "io_line": io_lines[0],
           "cli_args": golden.get("cli_args", []), "reads_in": n_in,
           "records_out": n_out, "generate_s": t_gen, "run_s": t_run,
           "reads_per_s": n_in / t_run, "run_s_recorded": t_rec,
           "kernel_launches": launches, "gathered_launches": per_launch,
           "gathered_vote_ms": sum(p["ms"] for p in per_launch),
           "output_digest_equal": out_ok, "report_stats_equal": rep_ok,
           "stage_seconds": stages}
    emit(res)
    return res


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


def phase_full(torch, np):
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _patched(vote, "pallas_vote_window", recorded), \
            _patched(streaming, "run_streaming", counted_stream):
        _zero_counters(vote)
        rc, err, t_run, n_out, output_ok, report_ok = _deep_panel_run(
            torch, bam, fa, os.path.join(WORK, "full"), golden)
        launches = _counters(vote)
    peak = torch.cuda.max_memory_allocated()
    if rc:
        fail(4, f"CLI exit code {rc}: {err[-2000:]}")
    io_lines = _io_lines(err)
    if len(streamed) != 1 or io_lines != [_streaming_line()]:
        fail(4, f"the deep panel did not go through run_streaming once on "
                f"the native core: calls={len(streamed)} lines={io_lines}")
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[stage\] (\S+): ([0-9.]+)s", err)}
    ok = (output_ok and report_ok and launches["vote_window"] > 0
          and launches["vote_window"] == len(per_launch))
    emit({"phase": 4, "name": "full-size deep panel vs golden, streaming "
                              "path", "ok": ok,
          "path": "parallel/streaming.run_streaming", "io_line": io_lines[0],
          "codec": native.codec(),
          "qual_nibble_table_per_launch": qtables,
          "workload": golden["workload"], "reads_in": n_in,
          "records_out": n_out, "generate_s": t_gen, "setup_s": t_setup,
          "run_s": t_run, "reads_per_s": n_in / t_run,
          "max_memory_allocated": peak, "kernel_launches": launches,
          "window_launches_K_J_sumcounts": per_launch,
          "input_digest_equal": input_ok, "output_digest_equal": output_ok,
          "report_stats_equal": report_ok, "stage_seconds": stages})
    if not ok:
        fail(4, "output differs from the golden digests, or the fused "
                "window kernel's launches do not match the window calls")
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
            _zero_counters(vote)
            rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
                torch, bam, fa, os.path.join(WORK, f"shards_{tag}"), golden,
                extra)
            launches = _counters(vote)
            if rc or not (out_ok and rep_ok):
                fail("4b", f"--shards {n_shards} run ({tag}) failed or "
                           f"differs from the golden digests: rc={rc} "
                           f"{err[-1500:]}")
            runs.append({"run": tag, "run_s": t_run, "records_out": n_out,
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
                _environ(GENCORE_NO_STREAM="1"), core():
            _zero_counters(vote)
            rc, err, t_run, n_out, out_ok, rep_ok = _deep_panel_run(
                torch, bam, fa, os.path.join(WORK, f"in_memory_{tag}"),
                golden, ["--windows", str(n_windows)])
            launches = _counters(vote)
        if rc:
            fail("4c", f"CLI exit code {rc} ({tag}): {err[-2000:]}")
        stages = {m.group(1): float(m.group(2)) for m in re.finditer(
            r"\[stage\] (\S+): ([0-9.]+)s", err)}
        runs[tag] = {"io_line": _io_lines(err), "run_s": t_run,
                     "records_out": n_out, "kernel_launches": launches,
                     "output_digest_equal": out_ok,
                     "report_stats_equal": rep_ok,
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
    Returns (kernel inputs, qual table, class args, kw, mismatches, max
    abs err)."""
    from gencore_tpu_torch.core import vote
    (seq_dev, qual_dev, score_dev, genome, gp, hr, hm, jp, qtable,
     class_args) = largest["args"]
    kw = largest["kw"]
    dev = seq_dev.device
    refbase_dev = vote._window_refbase(genome, gp, hr, hm, jp, kw["L"], dev)
    qt = None if qtable is None else vote.to_device(qtable, dev)
    mats = (seq_dev, qual_dev, score_dev, refbase_dev)
    got = vote.vote_window(*mats, qt, class_args, **kw)
    torch.cuda.synchronize()
    want = vote.vote_window_plain(*[t.cpu() for t in mats],
                                  None if qt is None else qt.cpu(),
                                  class_args, **kw)
    mism, err = _compare_window(got, want)
    if mism:
        fail(phase, f"vote_window kernel != twin on a replayed launch "
                    f"{largest['classes']}: {mism} mismatching bytes")
    return mats, qt, qtable, class_args, kw, mism, err


def phase_replay(torch, np, largest):
    """The deep panel's largest window launch, replayed."""
    from gencore_tpu_torch.core import vote
    mats, qt, qtable, class_args, kw, mism, err = _replay_window(
        torch, largest, 5)
    seq_dev, refbase_dev = mats[0], mats[3]
    t = _timings(
        torch, lambda: vote.vote_window_plain(*mats, qt, class_args, **kw),
        lambda: vote.vote_window(*mats, qt, class_args, **kw),
        "vote_window_kernel", 5, 50)
    N, L = seq_dev.shape
    n_bytes, n_ops, n_members = _window_bound(
        np, class_args, kw["classes"], N, L, refbase_dev.shape[0],
        kw["out_len"] or L, qtable)
    b_ms, b_by = bound(n_bytes, n_ops)
    res = {"classes_K_J_sumcounts": largest["classes"], "N": N, "L": L,
           "out_len": kw["out_len"], "qtable": qtable is not None,
           "mismatches": mism, "max_abs_err": err, **t, "bytes": n_bytes,
           "int_ops": n_ops, "bound_ms": b_ms, "bound_by": b_by,
           "share_of_bound": b_ms / t["ms"]}
    emit({"phase": 5, "name": "largest deep-panel window launch, replayed",
          "ok": True, **res})
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


def phase_busy(torch, bam, fa, golden):
    """One profiled deep-panel run with the plain composition (before the
    fused kernel) and one with the fused kernel (after)."""
    from torch.profiler import ProfilerActivity, profile

    from gencore_tpu_torch.core import vote
    res = {}
    for tag in ("before", "after"):
        d = os.path.join(WORK, f"busy_{tag}")
        os.makedirs(d, exist_ok=True)
        with contextlib.ExitStack() as stack:
            if tag == "before":
                stack.enter_context(_patched(vote, "vote_window",
                                             vote.vote_window_plain))
            vote.LAUNCHES = 0
            vote.WINDOW_LAUNCHES = 0
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                rc, err, t_run, _n, out_ok, rep_ok = _deep_panel_run(
                    torch, bam, fa, d, golden)
            counted = {"vote": vote.LAUNCHES,
                       "vote_window": vote.WINDOW_LAUNCHES}
        if rc or not (out_ok and rep_ok):
            fail(6, f"profiled deep-panel run ({tag}) failed or differs "
                    f"from the golden digests: rc={rc} {err[-1000:]}")
        if _io_lines(err) != [_streaming_line()]:
            fail(6, f"profiled deep-panel run ({tag}) did not take the "
                    f"streaming path on the native core: {_io_lines(err)}")
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        res[tag] = {"wall_s_profiled": t_run, "kernel_launches": counted,
                    "io_line": _io_lines(err)[0],
                    **_device_activity(trace)}
        os.remove(trace)
    emit({"phase": 6, "name": "deep-panel device busy, before/after",
          "ok": True,
          "before": "vote_window_plain (csrc/vote.cu + plain-torch "
                    "epilogue and concat), substituted for this run only",
          "after": "pallas_vote_window (csrc/vote_window.cu)", **res})
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
    totals = {"vote": 0, "vote_full": 0, "vote_window": 0}
    largest = {"sum_counts": -1}
    t0 = time.perf_counter()
    for name, case in gc.CASES.items():
        golden = gc.load_golden(name)
        for route in case.routes:
            rec = (name, route) == ("defaults_noumi", "default")
            with (_patched(vote, "pallas_vote_window",
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
            if run["differences"] or not any(launches.values()):
                emit({"phase": 9, "ok": False, **run})
                fail(9, f"{name} on route {route} differs from its golden "
                        f"digests ({run['differences']}) or launched no "
                        "vote kernel")
    t_runs = time.perf_counter() - t0
    if largest["sum_counts"] < 0:
        fail(9, "defaults_noumi launched no window vote to replay")
    mats, _qt, _qtable, _ca, kw, w_mism, w_err = _replay_window(
        torch, largest, 9)
    N, L = mats[0].shape
    if L != 128:
        fail(9, f"defaults_noumi's window launch has L={L}, not 128")
    K, J = kw["classes"][0]
    arrs = _vote_inputs(np, K, J, L, N, 128)
    cpu = [torch.from_numpy(a) for a in arrs]
    got = vote.vote_core(*[t.cuda() for t in cpu], **KW)
    torch.cuda.synchronize()
    want = vote.vote_core_plain(*cpu, hi=KW["hi"], mod=KW["mod"],
                                lo=KW["lo"], bsr=KW["base_score_req"],
                                rnum=KW["ratio_num"], rden=KW["ratio_den"])
    c_mism = sum(int((g.cpu() != w).sum()) for g, w in zip(got, want))
    c_err = max(int((g.cpu().long() - w.long()).abs().max())
                for g, w in zip(got, want))
    if c_mism:
        fail(9, f"vote kernel != plain twin at L=128 (K={K}, J={J}, N={N}): "
                f"{c_mism} mismatches")
    res = {"phase": 9, "name": "case matrix (tools/golden_compare.py) on "
                               "cuda vs golden digests", "ok": True,
           "cases": len(gc.CASES), "runs": len(runs),
           "duplex_consensus_reads": {
               r["case"]: r["summary"]["duplex_consensus_sequence"]
               for r in runs if r["summary"]["duplex_consensus_sequence"]},
           "generate_s": t_gen, "runs_s": t_runs,
           "kernel_launches": totals,
           "gathered_cases": sorted({r["case"] for r in runs
                                     if r["kernel_launches"]["vote"]}),
           "L128": {"window_launch_K_J_sumcounts": largest["classes"],
                    "N": N, "L": L, "vote_window_mismatches": w_mism,
                    "vote_window_max_abs_err": w_err,
                    "vote_core_shape": {"K": K, "J": J, "N": N},
                    "vote_core_mismatches": c_mism,
                    "vote_core_max_abs_err": c_err,
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
    Each shard's engine stages (StageTimer sums) are printed beside it."""
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
    stages = {}
    os.makedirs(out_dir, exist_ok=True)
    for s in shard_ids:
        sub = windows.subset_batch(batch,
                                   np.nonzero((kind > 0) & (shard == s))[0])
        eng = VectorEngine(opt, header, fasta=fasta, device=device)
        lap(f"shard {s}: subset and engine construction")
        table = eng.run(sub, checkpoint=ck, watermark=wm,
                        count_pre_reads=False)
        if device != "cpu":
            torch.cuda.synchronize()
        lap(f"shard {s}: eng.run")
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
                      torch.get_num_threads(), "eng_stages": stages}),
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
    2-host run (two processes on one card, one core each), then one more
    pinned host of both shards through host_steps, which times each step
    of run_host on its own (printed on its own line)."""
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
    _zero_counters(vote)
    dry = entry.dryrun_multichip(1, device="cuda:0", busy_reps=2,
                                 workload=workload)
    t_dry = time.perf_counter() - t0
    dry_launches = _counters(vote)
    if dry["pinned_efficiency"] is None or not dry_launches["vote_window"]:
        fail(10, "dryrun_multichip(1) skipped its pinned 2-host run or "
                 "launched no window vote")
    steps = _pinned_host_steps(*workload, os.path.join(wd, "steps"),
                               sorted(os.sched_getaffinity(0))[0])
    emit({"phase": 10, "name": "run_host's steps, one host of both shards "
                               "pinned to one core on cuda:0", **steps})
    res = {"phase": 10, "name": "entry() vs consensus_plain; "
                                "dryrun_multichip(1) on cuda:0", "ok": True,
           "entry": {"shape": list(args[0].shape), "mismatches": mism,
                     "max_abs_err": err, "kernel_launches": launches,
                     "tolerance": "exact (0 mismatches)"},
           "dryrun": dry, "dryrun_s": t_dry, "generate_s": t_gen,
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
    piles = phase_deep_piles(torch, np)
    full = phase_full_kernel(torch, np)
    phase_small(torch)
    full_bins = phase_full_bins(torch)
    bam, fa, golden, launches, largest = phase_full(torch, np)
    shard_runs = phase_shards(torch, bam, fa, golden)
    mem_runs = phase_in_memory(torch, bam, fa, golden)
    rep = phase_replay(torch, np, largest)
    phase_busy(torch, bam, fa, golden)
    ud = phase_ultradeep(torch, np)
    mesh_res = phase_mesh(torch, np)
    t9 = time.perf_counter()
    cases = phase_cases(torch, np)
    phase_entry(torch)
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
         "source": "gencore_tpu_torch/csrc/vote.cu (Bins6)",
         "replaces": "gencore_tpu/core/pallas_vote.py:178",
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
         "shape": f"phase 2c, J={pile['J']}, K={pile['K']}, L={pile['L']}, "
                  f"split {pile['split']}; phase 2a sum over K in "
                  f"{list(K_CLASSES)} at J={J_PHASE2}: {vk['ms']} ms"},
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
                  f"L={L_PHASE2}"}],
        "seconds": time.perf_counter() - t_start,
        "seconds_phases_9_to_11": t_new})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
