"""On-card A/B of kernel source variants of csrc/vote.cu,
csrc/vote_window.cu, csrc/upload_score.cu and csrc/upload_dense.cu.

    python3 -m gencore_tpu_torch.tools.kernel_ab DIR_A DIR_B [...]
        [--window | --upload | --dense] [--profile] [--reps N]

Each DIR is a copy of gencore_tpu_torch/csrc with one change, or the csrc
directory of another checkout of the package (a `git archive` of another
commit unpacked under build/). A variant runs through the wrapper module
beside it, DIR/../core/vote.py, when there is one, so that a checkout of
another commit runs with its own wrapper and upload layout; else through
this checkout's core/vote.py. The script builds a kernel library from each
DIR (nvcc, as core/vote.py builds it, into build/kernel_ab/<name>/), then
for every shape calls the entry with each library in turns (A, B, ...,
..., B, A), checks that all outputs are equal byte for byte, and prints
one JSON line per shape with each variant's device ms per call (CUDA
events around each call, the stream kept busy ahead of them, median of
--reps) and, for the window entry, the kernel's own median duration from
a torch.profiler trace (`kernel_ms`), the time per call of --reps calls
back to back, host work included (`call_ms`), and the host's own time per
call, from the call to its return, each call made on an idle stream
(`host_ms`, median of --reps), and a part of that host time, the median
of --reps calls on the host alone: the variant's `window_upload` (the job
table and the refbase sources packed into one buffer; `upload_ms`). A
keyword argument of the recorded launch that a variant's vote_window does
not take is left out of that variant's calls; a variant's window result
and this checkout's are compared by their wire buffer and dense
fallbacks (chip_smoke._compare_window). First it prints a line per variant
with each kernel's registers and spills (ptxas), its SASS instructions
(`cuobjdump -sass` of the library) and, where the library has
gc_vote_window_grid, the window kernel's resident blocks per SM at
L = 160.

Shapes without --window: the gathered entry vote.vote_gathered (the vote
with its epilogue, sparse with a qual table, as the engine runs it) at
the deep piles of chip_smoke.py phase 2c (J in {8, 32, 128}) and the
k-classes 16, 64 and 256 of phase 2a at J = 4096, each job's refbase row
named by index in a window of 2J + 5 rows (chip_smoke._with_refsrc), and
at the long_amplicon panel's gathered launch of the most (member, job)
slots (L = 320), recorded from one CLI run of it on the card as chip_smoke
phase 7b replays it. Every variant runs the rows form (the refbase rows
given ready-made, [J, L]); a variant whose vote_gathered takes `refsrc`
also reads the rows where they lie, from the window's sources
(`takes_refsrc`). Each shape's line gives the device ms of each
(variant, form) over the turns A, B, ..., B, A and whether every output
equals the first variant's rows form; with --profile also each kernel's
median duration by name. It also gives, per variant, host times (each
the median of --reps calls from the call to its return on an idle
stream, in the same turns): `host_ms`, vote_gathered in the rows form on
tensors on the card; `bucket_host_ms`, one bucket dispatched from host
arrays as that checkout's engine dispatches a gathered bucket (with
`refsrc`: pallas_vote_gathered given the host arrays and the bucket's
refbase row indices into the window's sources, which it sends up in one
pinned copy; without: the host arrays sent up one by one, the bucket's
rows gathered from the window's refbase rows on the card, then
pallas_vote_gathered); and `window_host_ms`, what that engine does once a
window before its buckets (window_refsrc, the sources sent up; or
vote.refbase, K11's launch).

Shapes with --window: the window entry vote.vote_window (csrc/vote_window.cu)
at (1) the deep panel's largest window launch, as chip_smoke.py phase 5
replays it: the deep panel (workloads.deep_panel, 240k reads) is run once
through the port's CLI on the card with this checkout's library and its
largest window launch recorded (L = 160, k-classes 4 and 16, qual table,
out_len = L); (2) phase 2b's classes K = 4 and 16 at J = 4096, L = 160,
with a qual table, out_len = L; (3) phase 2b's K = 32, 64, 128 and 256
at the same sizes. A shape's line also gives its (job, position) pairs.

Shapes with --upload: the upload-and-score entry kernels.upload_score
(csrc/upload_score.cu), each variant through the core/kernels.py beside
its DIR when there is one (driving that variant's vote module), at (1)
the deep panel's largest deferred upload, as chip_smoke.py phase 5
replays it (recorded from one CLI run, as --window records its launch);
(2) phase 2e's timed shape (48,000 rows, w = 150, L = 160, the deep
panel's flags); (3) the same flags at 72,000 rows with u32 mate rows,
which only the variants whose upload_score takes `mate32` run
(`upload_shapes`). Each round of turns (--rounds, default 1) calls the
variants in the order A, B, ..., B, A. A shape's line gives each
variant's `kernel_ms` per turn (the kernel's median duration in a
torch.profiler trace of --reps calls), `host_ms` and `call_ms` as above,
and the mismatching bytes against the first variant.
A variant's library that exports gc_upload_score_split (a copy
instrumented with clock64()) adds a `split` line per shape: the cycles of
one launch summed per part; one that exports gc_upload_score_grid adds
the grid it launches and its blocks per SM to its build line.

Shapes with --dense: the dense staging route's two entries,
kernels.upload_unpack and kernels.score_map (csrc/upload_dense.cu), each
variant through the core/kernels.py beside its DIR as with --upload, at
(1) chip_smoke.py phase 2f's timed shapes (`dense_shapes`: the unpack at
each of DENSE_SHAPES with its DENSE_TIMED_MODES, the score map at each of
DENSE_SCORE_SHAPES, packed and int32) and (2) the long_amplicon panel's
largest unpack and score map, recorded from one CLI run of it on the card
(chip_smoke.py phase 7b replays the same). Turns and rounds as with
--upload; a shape's line gives each variant's device ms per turn (CUDA
events around each call, the stream kept busy ahead of it, median of
--reps; `ms`), its time per call back to back (`call_ms`), the bytes and
bound (chip_smoke's _unpack_bound / _score_bound), each variant's share
of the bound at its median, and the mismatching bytes against the first
variant (a variant that differs, an ablation say, is timed all the same,
and the exit code is 1). A last line times the recorded unpack and score
map back to back, as a window runs them (`_window_pair`). A variant's
library that exports gc_dense_split (a copy instrumented with clock64())
adds a `split` line per shape: its 16 counters after one launch, named
per part (`DENSE_SPLIT_PARTS`).

Needs a card. Device printf output of a variant (a scratch copy
instrumented with clock64(), say) goes to standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SHAPES = ([("pile", J, K) for J, K in ((8, 512), (32, 2048), (32, 4096),
                                       (128, 4096))]
          + [("2a", 4096, K) for K in (16, 64, 256)])
WINDOW_K = (4, 16, 32, 64, 128, 256)
# --upload: (name, rows, u32 mate rows) of the generated shapes; the
# recorded deep-panel upload comes first
UPLOAD_SHAPES = (("2e", 48_000, False), ("mate32", 72_000, True))
UPLOAD_W, UPLOAD_L = 150, 160
# the deep panel's flags (kernels.UPLOAD_FLAGS order, without mate32)
UPLOAD_DEEP_FLAGS = (True, True, False, True, True, True, False)
# gc_dense_split's counters: summed cycles per part, and threads
DENSE_SPLIT_PARTS = {
    "upload_unpack": {0: "index_math", 1: "lens_and_rows",
                      2: "staging_loads", 3: "arithmetic", 4: "stores",
                      7: "threads"},
    "score_map": {8: "index_math", 9: "geometry_and_qual_loads",
                  10: "seq_len_mate_loads", 11: "mate_byte_loads",
                  12: "arithmetic", 13: "stores", 15: "threads"}}


def _kernel_medians(torch, cs, fn, reps=10):
    """{kernel name: median duration in ms} over a profiled run of fn."""
    from statistics import median

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(cs.WORK, "kernel_ab_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    by = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            m = re.search(r"(\w+_kernel)<[^>]*?(Bins\d+)", e.get("name", ""))
            name = " ".join(m.groups()) if m else e.get("name", "")[:48]
            by.setdefault(name, []).append(float(e["dur"]) / 1e3)
    return {k: median(v) for k, v in by.items()}


def _wrapper(d, default):
    """A fresh instance of the vote module that drives the library built
    from csrc dir d: the checkout's own core/vote.py beside d, else this
    checkout's (`default`), which stays untouched."""
    path = os.path.join(os.path.dirname(os.path.abspath(d)), "core",
                        "vote.py")
    if not os.path.exists(path):
        path = default.__file__
    name = "kernel_ab_vote_" + re.sub(r"\W", "_", os.path.abspath(d))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(dirs, default):
    """{dir: wrapper module with its library loaded}."""
    mods = {}
    for d in dirs:
        mod = _wrapper(d, default)
        mod.CSRC_DIR = os.path.abspath(d)
        mod.BUILD_DIR = os.path.join(
            REPO, "build", "kernel_ab",
            re.sub(r"\W", "_", os.path.relpath(os.path.abspath(d), REPO)))
        mod.build_library()
        mods[d] = mod
    return mods


def _kernels_module(d, vote_mod, default):
    """A fresh instance of the kernels module beside csrc dir d (the
    checkout's own core/kernels.py, else this checkout's, `default`) that
    launches through vote_mod, the variant's vote module."""
    path = os.path.join(os.path.dirname(os.path.abspath(d)), "core",
                        "kernels.py")
    if not os.path.exists(path):
        path = default.__file__
    name = "kernel_ab_kernels_" + re.sub(r"\W", "_", os.path.abspath(d))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.vote = vote_mod
    return mod


def takes_mate32(kernels_mod) -> bool:
    """Whether a variant's upload_score takes u32 mate rows."""
    return "mate32" in inspect.signature(kernels_mod.upload_score).parameters


def upload_shapes(kmods):
    """[(name, rows, mate32, the variants that run it)] of the generated
    --upload shapes: a variant whose upload_score lacks `mate32` is left
    out of the u32 shape. kmods: {dir: kernels module}."""
    return [(name, n, m32, [d for d, k in kmods.items()
                            if not m32 or takes_mate32(k)])
            for name, n, m32 in UPLOAD_SHAPES]


def _build_report(torch, d, mod):
    """Registers and spills per kernel, SASS instructions per kernel, and
    the window kernel's blocks per SM at L = 160 (new libraries only)."""
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'(.*?)Used (\d+) "
                         r"registers", mod.BUILD_LOG, re.S):
        spill = re.search(r"(\d+) bytes spill stores", m.group(2))
        regs[m.group(1)] = [int(m.group(3)),
                            int(spill.group(1)) if spill else None]
    sass = {}
    cuobjdump = os.path.join(os.path.dirname(mod._find_nvcc()), "cuobjdump")
    r = subprocess.run([cuobjdump, "-sass", mod.library_path()],
                       capture_output=True, text=True)
    for fn in re.split(r"\n\s*Function : ", r.stdout)[1:]:
        name = fn.split("\n", 1)[0].strip()
        sass[name] = len(re.findall(r"/\*[0-9a-f]{4}\*/\s+[^;]*;", fn))
    per_sm = None
    if hasattr(mod.build_library(), "gc_vote_window_grid"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = mod.window_grid(160, 1 << 30, torch.device("cuda", 0)) / sms
    out = {"variant": d, "registers_spills": regs, "sass_instructions": sass,
           "window_blocks_per_sm_L160": per_sm}
    lib = mod.build_library()
    if hasattr(lib, "gc_upload_score_grid"):
        import ctypes
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        lib.gc_upload_score_grid.argtypes = [ctypes.c_int]
        lib.gc_upload_score_grid.restype = ctypes.c_int
        with torch.cuda.device(0):
            grid = lib.gc_upload_score_grid(1 << 30)
        out["upload_grid"] = grid
        out["upload_blocks_per_sm"] = grid / sms
    return out


def takes_refsrc(vote_mod) -> bool:
    """Whether a variant's vote_gathered reads refbase rows by index."""
    return "refsrc" in inspect.signature(vote_mod.vote_gathered).parameters


def _long_amplicon_gathered(torch, cs):
    """The long_amplicon panel's gathered launch of the most (member, job)
    slots, recorded from one CLI run on the card with this checkout's
    vote module: (args, kw), its refbase sources in kw["refsrc"]."""
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.tools import workloads
    bam, fa = workloads.long_amplicon(os.path.join(cs.WORK, "workloads"))
    calls = []
    d = os.path.join(cs.WORK, "kernel_ab_run")
    os.makedirs(d, exist_ok=True)
    with cs._patched(vote, "vote_gathered", cs._gathered_recorder(calls)):
        rc, err = cs._cli(["-i", bam, "-o", os.path.join(d, "out.bam"),
                           "-r", fa, "--device", "cuda"])
    if rc:
        raise RuntimeError(f"long_amplicon run failed: {err[-2000:]}")
    return max(calls, key=lambda c: c[0][3].numel())


def _gathered_shapes(torch, np, cs, dev):
    """(name, J, K, L, rows-form args on the card, kw, source form) of
    each gathered shape, the recorded 7b launch last."""
    for kind, J, K in SHAPES:
        arrs = (cs._pile_inputs(np, K, J, 160, J + K) if kind == "pile"
                else cs._vote_inputs(np, K, J, 160, 40960, K))
        args, kw = cs._gathered_args(np, arrs, J + K, "sparse_qtable")
        gpu, src = cs._with_refsrc(torch, np, args, J + K + 2, dev,
                                   2 * J + 5)
        yield kind, J, K, 160, gpu, kw, src
    args, kw = _long_amplicon_gathered(torch, cs)
    from gencore_tpu_torch.core import vote
    src = kw.pop("refsrc")
    K, J = args[3].shape
    L = args[0].shape[1]
    gpu = list(args)
    gpu[7] = vote.refbase_rows(src, L)
    yield "7b", J, K, L, gpu, kw, src


def _idle_host_ms(torch, fn, reps):
    """Median ms from fn's call to its return, each call on an idle
    stream."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def bucket_calls(m, gpu, src, kw):
    """(window, bucket): what a checkout's engine does with vote module m
    once a window ahead of its gathered buckets, and for one bucket of
    host arrays (the rows of gpu, each job's refbase row named by index
    in the window's sources src): with `refsrc` (takes_refsrc), the
    sources sent up once (window_refsrc) and the bucket's host arrays and
    indices handed to pallas_vote_gathered; without, the window's rows
    built on the card (vote.refbase, K11) and per bucket the host arrays
    sent up one by one and the bucket's rows gathered there."""
    import torch
    genome, gp, hm, jp, hr, ridx = src
    host = {k: t.cpu().numpy() for k, t in (
        ("gp", gp), ("hm", hm), ("jp", jp), ("hr", hr), ("ridx", ridx))}
    mats = gpu[:3]
    rows_t, row0, valid, jl = (t.cpu().numpy() for t in gpu[3:7])
    qtable = None if gpu[8] is None else gpu[8].cpu().numpy()
    dev = genome.device
    if takes_refsrc(m):
        sources = m.window_refsrc(genome, host["gp"], host["hm"], host["jp"],
                                  host["hr"])

        def window():
            return m.window_refsrc(genome, host["gp"], host["hm"],
                                   host["jp"], host["hr"])

        def bucket():
            return m.pallas_vote_gathered(
                *mats, rows_t, row0, valid, jl, None, qtable,
                refsrc=(*sources, host["ridx"]), **kw)
        return window, bucket
    L = mats[0].shape[1]
    table = m.refbase(genome, host["gp"], host["hr"], host["hm"],
                      host["jp"], L)

    def window():
        return m.refbase(genome, host["gp"], host["hr"], host["hm"],
                         host["jp"], L)

    def bucket():
        r = m.to_device(host["ridx"], dev).to(torch.int64).clamp(
            0, table.shape[0] - 1)
        return m.pallas_vote_gathered(
            *mats, m.to_device(rows_t, dev), m.to_device(row0, dev),
            m.to_device(valid, dev), m.to_device(jl, dev), table[r],
            None if qtable is None else m.to_device(qtable, dev), **kw)
    return window, bucket


def _gathered(torch, np, cs, mods, dirs, opts, dev):
    for kind, J, K, L, gpu, kw, src in _gathered_shapes(torch, np, cs, dev):
        def calls(m):
            forms = cs._forms(m, gpu, src, kw)
            return forms if takes_refsrc(m) else {"rows": forms["rows"]}
        runs = [(d, form, fn) for d in dirs
                for form, fn in calls(mods[d]).items()]
        outs, ms, kernels = {}, {}, {}
        for d, form, fn in runs + runs[::-1]:
            key = f"{d} {form}"
            outs[key] = fn()
            ms.setdefault(key, []).append(cs._kernel_ms(torch, fn,
                                                        opts.reps))
            if opts.profile and key not in kernels:
                kernels[key] = _kernel_medians(torch, cs, fn)
        hosts, buckets, windows = {}, {}, {}
        for d in dirs + dirs[::-1]:
            m = mods[d]
            window, bucket = bucket_calls(m, gpu, src, kw)
            outs[f"{d} bucket"] = bucket()
            hosts.setdefault(d, []).append(_idle_host_ms(
                torch, calls(m)["rows"], opts.reps))
            buckets.setdefault(d, []).append(_idle_host_ms(
                torch, bucket, opts.reps))
            windows.setdefault(d, []).append(_idle_host_ms(
                torch, window, opts.reps))
        ref = outs[f"{dirs[0]} rows"]
        equal = all(cs._compare(o, ref)[0] == 0 for o in outs.values())
        print(json.dumps({"shape": kind, "J": J, "K": K, "L": L, "split":
                          mods[dirs[0]].split_size(K, J),
                          "outputs_equal": equal, "ms": ms,
                          "host_ms": hosts, "bucket_host_ms": buckets,
                          "window_host_ms": windows,
                          "kernel_ms": kernels or None}), flush=True)
        if not equal:
            return 1
    return 0


def _deep_panel_window(torch, np, cs):
    """The deep panel's largest window launch, recorded from one CLI run
    on the card (chip_smoke.py phases 4 and 5): (matrices and genome on
    the card, gp, hr, hm, jp, qtable, class_args, kw, classes)."""
    from gencore_tpu_torch.core import vote
    from gencore_tpu_torch.tools import workloads
    bam, fa = workloads.deep_panel(os.path.join(cs.WORK, "workloads"))
    largest = {"sum_counts": -1}
    d = os.path.join(cs.WORK, "kernel_ab_run")
    os.makedirs(d, exist_ok=True)
    with cs._patched(vote, "pallas_vote_window",
                     cs._window_recorder(np, vote, largest)):
        rc, err = cs._cli(["-i", bam, "-o", os.path.join(d, "out.bam"),
                           "-r", fa, "--device", "cuda"])
    if rc:
        raise RuntimeError(f"deep panel run failed: {err[-2000:]}")
    (seq, qual, score, genome, gp, hr, hm, jp, qtable,
     class_args) = largest["args"]
    return ((seq, qual, score, genome), (gp, hr, hm, jp), qtable,
            class_args, largest["kw"], largest["classes"])


def _phase2b_window(torch, np, cs, K, dev):
    """Phase 2b's class K at J = 4096, L = 160, with a qual table."""
    J, L, N = cs.J_PHASE2, cs.L_PHASE2, cs.N_PHASE2
    Jw = J + J // 4
    rng = np.random.default_rng(1000 + K)
    seq, qual, score = cs._matrices(np, rng, L, N)
    srcs = cs._refbase_sources(np, rng, Jw, L)
    class_args = cs._window_class_args(np, rng, K, J, N, Jw, L)
    mats = tuple(torch.from_numpy(a).to(dev) for a in (seq, qual, score,
                                                       srcs[0]))
    kw = dict(classes=((K, J),), L=L, out_len=L, **cs.KW)
    sums = [[K, J, int(np.asarray(class_args[1]).astype(np.int64).sum())]]
    return mats, srcs[1:], cs._qtable(np), class_args, kw, sums


def _host_median(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _taken(fn, kw):
    """kw without the keywords fn does not take."""
    params = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in params}


def _window(torch, np, cs, mods, dirs, opts, dev):
    shapes = [("deep_panel_largest", None)] + [("2b", K) for K in WINDOW_K]
    for kind, K in shapes:
        if kind == "2b":
            mats, srcs, qtable, class_args, kw, sums = _phase2b_window(
                torch, np, cs, K, dev)
        else:
            mats, srcs, qtable, class_args, kw, sums = _deep_panel_window(
                torch, np, cs)
        L = kw["L"]
        outs, ms, kms, calls, hosts, uploads = {}, {}, {}, {}, {}, {}
        for d in dirs + dirs[::-1]:
            def call(m=mods[d]):
                return m.vote_window(*mats, *srcs, qtable, class_args,
                                     **_taken(m.vote_window, kw))

            def upload(m=mods[d]):
                return m.window_upload(
                    class_args, kw["classes"], srcs[0], srcs[2], srcs[3],
                    qtable, srcs[1])
            try:
                outs[d] = call()
                torch.cuda.synchronize()
            except Exception:
                print(f"kernel_ab: {d} failed at shape {kind}",
                      file=sys.stderr, flush=True)
                raise
            ms.setdefault(d, []).append(cs._kernel_ms(torch, call,
                                                      opts.reps))
            kms.setdefault(d, []).append(cs._device_ms(
                torch, call, opts.reps, "vote_window_kernel")[0])
            calls.setdefault(d, []).append(cs._time_ms(torch, call,
                                                       opts.reps))
            host = []
            for _ in range(opts.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                host.append((time.perf_counter() - t0) * 1e3)
            hosts.setdefault(d, []).append(statistics.median(host))
            uploads.setdefault(d, []).append(_host_median(upload, opts.reps))
            torch.cuda.synchronize()
        ref = outs[dirs[0]]
        mism = {d: cs._compare_window(o, ref)[0] for d, o in outs.items()}
        jobs = sum(J for _K, J in kw["classes"])
        line = {"shape": kind, "classes_K_J_sumcounts": sums, "L": L,
                "Jw": len(srcs[0]), "job_positions": jobs * L,
                "mismatching_bytes": mism, "ms": ms, "kernel_ms": kms,
                "call_ms": calls, "host_ms": hosts, "upload_ms": uploads}
        print(json.dumps(line), flush=True)
        if any(mism.values()):
            return 1
    return 0


def _deep_panel_upload(cs):
    """The deep panel's largest deferred upload, recorded from one CLI run
    on the card (chip_smoke.py phases 4 and 5): (static, staging)."""
    from gencore_tpu_torch import engine
    from gencore_tpu_torch.tools import workloads
    bam, fa = workloads.deep_panel(os.path.join(cs.WORK, "workloads"))
    upload = {}
    d = os.path.join(cs.WORK, "kernel_ab_run")
    os.makedirs(d, exist_ok=True)
    with cs._patched(engine, "_upload_score_fn", cs._upload_recorder(upload)):
        rc, err = cs._cli(["-i", bam, "-o", os.path.join(d, "out.bam"),
                           "-r", fa, "--device", "cuda"])
    if rc:
        raise RuntimeError(f"deep panel run failed: {err[-2000:]}")
    return upload["static"], upload["staging"]


def _upload_split(torch, lib, fn):
    """One launch of fn under a library instrumented with clock64(): the
    cycles per part it summed (gc_upload_score_split fills and zeroes 16
    counters), or None for a library without it."""
    if not hasattr(lib, "gc_upload_score_split"):
        return None
    import ctypes
    buf = (ctypes.c_ulonglong * 16)()
    lib.gc_upload_score_split.argtypes = [ctypes.c_void_p]
    lib.gc_upload_score_split.restype = ctypes.c_int
    torch.cuda.synchronize()
    lib.gc_upload_score_split(buf)    # zeroes what the checks summed
    fn()
    torch.cuda.synchronize()
    if lib.gc_upload_score_split(buf):
        raise RuntimeError("gc_upload_score_split failed")
    return list(buf)


def _upload(torch, np, cs, mods, dirs, opts, dev):
    from gencore_tpu_torch.core import kernels
    from gencore_tpu_torch.tools import workloads
    kmods = {d: _kernels_module(d, mods[d], kernels) for d in dirs}
    shapes = [("deep_panel_largest", None, False, dirs)] + upload_shapes(kmods)
    for kind, n, m32, run in shapes:
        if not run:
            continue
        if kind == "deep_panel_largest":
            static, staging = _deep_panel_upload(cs)
        else:
            flags = UPLOAD_DEEP_FLAGS + (m32,)
            staging = workloads.upload_staging(
                np.random.default_rng(7), n, UPLOAD_W, UPLOAD_L,
                **dict(zip(kernels.UPLOAD_FLAGS, flags)))
            static = cs._upload_static(UPLOAD_W, UPLOAD_L, flags)
        (w, L, mode2, has_sedit, has_qdense, has_qedit, const_lens, hi, mod,
         lo, s_hi, s_mod, s_lo, s_bad, has_genome, no_overlap) = static[:16]
        kw = dict(device=dev, w=w, L=L, mode2=mode2, has_sedit=has_sedit,
                  has_qdense=has_qdense, has_qedit=has_qedit,
                  const_lens=const_lens, has_genome=has_genome,
                  no_overlap=no_overlap, hi=hi, mod=mod, lo=lo, s_hi=s_hi,
                  s_mod=s_mod, s_lo=s_lo, s_bad=s_bad)
        mate32 = len(static) > 16 and static[16]
        arrays = [np.asarray(a) for a in (*staging[:14], staging[15])]
        genome = staging[14]
        if not isinstance(genome, torch.Tensor):
            genome = torch.from_numpy(np.asarray(genome)).to(dev)
        outs, kms, calls, hosts, splits = {}, {}, {}, {}, {}
        for d in (run + run[::-1]) * opts.rounds:
            kd = dict(kw, mate32=True) if mate32 else kw

            def call(k=kmods[d], kd=kd):
                return k.upload_score(arrays, genome, **kd)
            try:
                outs[d] = call()
                torch.cuda.synchronize()
            except Exception:
                print(f"kernel_ab: {d} failed at shape {kind}",
                      file=sys.stderr, flush=True)
                raise
            if d not in splits:
                splits[d] = _upload_split(torch, mods[d].build_library(),
                                          call)
            kms.setdefault(d, []).append(cs._device_ms(
                torch, call, opts.reps, "upload_score_kernel")[0])
            calls.setdefault(d, []).append(cs._time_ms(torch, call,
                                                       opts.reps))
            hosts.setdefault(d, []).append(cs._host_ms(torch, call,
                                                       opts.reps))
        ref = outs[run[0]]
        mism = {d: cs._upload_compare(o, ref)[0] for d, o in outs.items()}
        n_bytes, _ops = cs._upload_bound(np, static, staging)
        print(json.dumps({
            "shape": kind, "n": len(staging[1]), "w": w, "L": L,
            "mate32": bool(mate32), "flags": dict(zip(
                kernels.UPLOAD_FLAGS, (mode2, has_sedit, has_qdense,
                                       has_qedit, const_lens, has_genome,
                                       no_overlap))),
            "bytes": n_bytes, "bound_ms": n_bytes / cs.HBM_BYTES_PER_S * 1e3,
            "mismatching_bytes": mism, "kernel_ms": kms, "call_ms": calls,
            "host_ms": hosts}), flush=True)
        for d, sp in splits.items():
            if sp is not None:
                print(json.dumps({"shape": kind, "variant": d,
                                  "split": sp}), flush=True)
        if any(mism.values()):
            return 1
    return 0


def dense_shapes(cs):
    """[(entry, name, spec)] of the generated --dense shapes, from
    chip_smoke (`cs`): the unpack at each of DENSE_SHAPES with its timed
    modes, then the score map at each of DENSE_SCORE_SHAPES."""
    return ([("upload_unpack", "2f", dict(n=n, w=w, L=L, seq_mode=sm,
                                          qual_mode=qm))
             for (n, w, L), (sm, qm) in zip(cs.DENSE_SHAPES,
                                            cs.DENSE_TIMED_MODES)]
            + [("score_map", "2f", dict(N=N, L=L, packed=packed))
               for N, L, packed in cs.DENSE_SCORE_SHAPES])


def _dense_inputs(torch, np, cs, kind, spec, seed, dev):
    """(args, kw) of one generated --dense shape, on `dev`, as phase 2f
    makes them."""
    from gencore_tpu_torch.tools import workloads
    rng = np.random.default_rng(seed)
    if kind == "upload_unpack":
        args = [torch.from_numpy(a).to(dev) for a in workloads.dense_staging(
            rng, spec["n"], spec["w"], spec["seq_mode"], spec["qual_mode"])]
        return args, {k: spec[k] for k in ("w", "L", "seq_mode",
                                           "qual_mode")}
    t = [torch.from_numpy(a).to(dev) for a in workloads.score_geometry(
        rng, spec["N"], spec["L"], spec["packed"])]
    if spec["packed"]:
        seq, qual, my_len, mate, meta = t
        return [seq, qual, mate, my_len], dict(meta=meta, **cs.SCORE_KW)
    seq, qual, mate, ms, ts, cl, my_len, left, sc = t
    return [seq, qual, mate, my_len], dict(
        my_start=ms, mate_start=ts, cmp_len=cl, is_left=left, scored=sc,
        **cs.SCORE_KW)


def _long_amplicon_dense(torch, cs):
    """The long_amplicon panel's largest unpack and score map, recorded
    from one CLI run on the card (chip_smoke.py phase 7b):
    {entry: (args, kw)}."""
    from gencore_tpu_torch.core import kernels
    from gencore_tpu_torch.tools import workloads
    bam, fa = workloads.long_amplicon(os.path.join(cs.WORK, "workloads"))
    largest = {}
    d = os.path.join(cs.WORK, "kernel_ab_run")
    os.makedirs(d, exist_ok=True)
    u_rec, s_rec = cs._dense_recorder(torch, largest)
    with cs._patched(kernels, "upload_unpack", u_rec), \
            cs._patched(kernels, "score_map", s_rec):
        rc, err = cs._cli(["-i", bam, "-o", os.path.join(d, "out.bam"),
                           "-r", fa, "--device", "cuda"])
    if rc:
        raise RuntimeError(f"long_amplicon run failed: {err[-2000:]}")
    return {k: (largest[k]["args"], largest[k]["kw"])
            for k in ("upload_unpack", "score_map")}


def _dense_split(torch, lib, kind, fn):
    """One launch of fn under a library instrumented with clock64(): the
    cycles per part it summed ({part: cycles}, gc_dense_split copying out
    and zeroing 16 counters), or None for a library without it."""
    if not hasattr(lib, "gc_dense_split"):
        return None
    import ctypes
    buf = (ctypes.c_ulonglong * 16)()
    lib.gc_dense_split.argtypes = [ctypes.c_void_p]
    lib.gc_dense_split.restype = ctypes.c_int
    torch.cuda.synchronize()
    if lib.gc_dense_split(buf):       # zeroes what earlier calls summed
        raise RuntimeError("gc_dense_split failed")
    fn()
    torch.cuda.synchronize()
    if lib.gc_dense_split(buf):
        raise RuntimeError("gc_dense_split failed")
    return {name: int(buf[i]) for i, name in DENSE_SPLIT_PARTS[kind].items()}


def _window_pair(torch, cs, kmods, dirs, opts, recorded):
    """The long_amplicon panel's largest unpack and score map back to
    back, the score map on the unpack's outputs, as a dense window runs
    them (a kernel timed alone in turns finds the previous call's dirty
    lines in L2): device ms of each and of the pair per variant and turn
    (CUDA events, the stream kept busy ahead), as called and after a
    128 MiB write that flushes L2."""
    from statistics import median
    (ua, ukw), (sa, skw) = recorded["upload_unpack"], recorded["score_map"]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=ua[0].device)
    line = {"entry": "upload_unpack + score_map", "shape": "7b",
            "rows": int(ua[0].shape[0])}
    for cold in (False, True):
        ms = {}
        for d in (dirs + dirs[::-1]) * opts.rounds:
            k, times = kmods[d], []
            for _ in range(opts.reps):
                if cold:
                    flush.fill_(1)
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                torch.cuda._sleep(2_000_000)
                ev[0].record()
                seq, qual, _lens = k.upload_unpack(*ua, **ukw)
                ev[1].record()
                k.score_map(seq, qual, *sa[2:], **skw)
                ev[2].record()
                ev[2].synchronize()
                times.append([ev[0].elapsed_time(ev[1]),
                              ev[1].elapsed_time(ev[2]),
                              ev[0].elapsed_time(ev[2])])
            ms.setdefault(d, []).append([median(t[i] for t in times)
                                         for i in range(3)])
        line["after_l2_flush" if cold else "as_called"] = {
            d: {"unpack_ms": [x[0] for x in v], "score_map_ms": [x[1] for x in v],
                "pair_ms": [x[2] for x in v]} for d, v in ms.items()}
    print(json.dumps(line), flush=True)


def _dense(torch, np, cs, mods, dirs, opts, dev):
    from statistics import median

    from gencore_tpu_torch.core import kernels
    kmods = {d: _kernels_module(d, mods[d], kernels) for d in dirs}
    shapes = dense_shapes(cs)
    recorded = _long_amplicon_dense(torch, cs)
    shapes += [(k, "7b", None) for k in ("upload_unpack", "score_map")]
    bad = 0
    for i, (kind, name, spec) in enumerate(shapes):
        if spec is None:
            args, kw = recorded[kind]
        else:
            args, kw = _dense_inputs(torch, np, cs, kind, spec, 6000 + i,
                                     dev)
        outs, ms, calls, splits = {}, {}, {}, {}
        for d in (dirs + dirs[::-1]) * opts.rounds:
            def call(fn=getattr(kmods[d], kind)):
                return fn(*args, **kw)
            try:
                outs[d] = call()
                torch.cuda.synchronize()
            except Exception:
                print(f"kernel_ab: {d} failed at {kind} {name}",
                      file=sys.stderr, flush=True)
                raise
            if d not in splits:
                splits[d] = _dense_split(torch, mods[d].build_library(),
                                         kind, call)
            ms.setdefault(d, []).append(cs._kernel_ms(torch, call,
                                                      opts.reps))
            calls.setdefault(d, []).append(cs._time_ms(torch, call,
                                                       opts.reps))
        ref = outs[dirs[0]]
        mism = {d: cs._upload_compare(o, ref)[0] for d, o in outs.items()}
        n_bytes, n_ops = (cs._unpack_bound if kind == "upload_unpack"
                          else cs._score_bound)(args, kw)
        b_ms, b_by = cs.bound(n_bytes, n_ops)
        static = {k: v for k, v in kw.items() if isinstance(v, (int, str))}
        print(json.dumps({
            "entry": kind, "shape": name, "rows": int(args[0].shape[0]),
            "L": int(args[0].shape[1]) if kind == "score_map" else kw["L"],
            "static": static, "bytes": n_bytes, "bound_ms": b_ms,
            "bound_by": b_by, "mismatching_bytes": mism, "ms": ms,
            "call_ms": calls,
            "share_of_bound": {d: b_ms / median(v) for d, v in ms.items()}}),
            flush=True)
        for d, sp in splits.items():
            if sp is not None:
                print(json.dumps({"entry": kind, "shape": name,
                                  "variant": d, "split": sp}), flush=True)
        del args, kw, outs
        bad += any(mism.values())
    _window_pair(torch, cs, kmods, dirs, opts, recorded)
    return 1 if bad else 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--window", action="store_true",
                      help="time the window entry (csrc/vote_window.cu)")
    kind.add_argument("--upload", action="store_true",
                      help="time the upload-and-score entry "
                           "(csrc/upload_score.cu)")
    kind.add_argument("--dense", action="store_true",
                      help="time the dense staging route's unpack and "
                           "score map (csrc/upload_dense.cu)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=1,
                    help="--upload, --dense: rounds of turns (A, B, "
                         "..., B, A)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    opts = parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from gencore_tpu_torch.core import vote
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(cs.WORK, exist_ok=True)
    dev = torch.device("cuda", 0)
    mods = _build(opts.dirs, vote)
    for d in opts.dirs:
        print(json.dumps(_build_report(torch, d, mods[d])), flush=True)
    run = (_window if opts.window else _upload if opts.upload
           else _dense if opts.dense else _gathered)
    rc = run(torch, np, cs, mods, list(opts.dirs), opts, dev)
    print(cs.nvidia_smi_line())
    return rc


if __name__ == "__main__":
    sys.exit(main())
