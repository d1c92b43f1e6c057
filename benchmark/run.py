"""One run of one cell of the benchmark of `gencore_tpu_torch`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's sample from the seed in a child process (a sorted
BAM over the configuration's genome, FASTA and BED), started before torch
is imported, while the program and its kernels load; a seed's sample is
kept in benchmark/cache/<config>/<traffic>/<seed>/, so a second run of a
seed makes none. One warm-up call on the sample itself follows. The
window then calls `gencore_tpu_torch.cli.main` in this process, once per
sample, back to back, as a user would run it (`--device cuda`, the
default streaming route, every output path given), until `--seconds`
have passed. After the window the plain reference (benchmark/reference)
runs over the same sample in parts, on every core (its records' digests
and report are kept beside the seed's sample), and the last sample's
output BAM and JSON report are compared with it. Each sample's host
readings (harness/samplers.HostClock) go to standard error.

With `--trace 0` the result line holds the cell's end-to-end metrics; with
`--trace 1` the window runs under the profiler, with `--debug` for the
stage table and a thread that samples what the program's threads are
doing, and the line holds the per-layer metrics, `busy_s`, `window_s` and
a breakdown. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):      # the program from the checkout's root
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import cells, check, gen, samplers, stages  # noqa: E402
from harness import trace as tr  # noqa: E402

PROGRAM = "gencore_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "gencore_tpu")
# each kernel a roofline reads, and the program's launch counters of it (a
# split vote.cu launch adds a decide_kernel, which no counter counts)
COUNTERS = {
    "vote_window_kernel": (("core.vote", "WINDOW_LAUNCHES"),),
    "vote_kernel": (("core.vote", "LAUNCHES"), ("core.vote", "FULL_LAUNCHES"),
                    ("core.vote", "VOTE_ONLY_LAUNCHES")),
    "upload_score_kernel": (("core.kernels", "UPLOAD_SCORE_LAUNCHES"),),
    "upload_unpack_kernel": (("core.kernels", "UPLOAD_UNPACK_LAUNCHES"),),
    "score_map_kernel": (("core.kernels", "SCORE_MAP_LAUNCHES"),),
}
KEEP_SEEDS = 12       # seeds' samples kept in the cache of a cell


def process_start() -> float:
    """The wall-clock time this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Sample:
    """One call of the program's CLI on the cell's sample."""

    def __init__(self, entry, argv: list):
        self.entry, self.argv = entry, argv

    def __call__(self) -> dict:
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            try:
                rc = self.entry(list(self.argv))
            except Exception as e:  # a sample that raises has failed
                print(f"{type(e).__name__}: {e}", file=sys.stderr)
                rc = -1
        t1 = time.perf_counter()
        text = err.getvalue()
        io_lines = [ln for ln in text.splitlines() if ln.startswith("I/O: ")]
        return {"rc": rc, "t0": t0, "t1": t1, "io": io_lines,
                "stages": stages.parse(text), "tail": text[-2000:]}


def streaming_ok(s: dict) -> bool:
    return s["rc"] == 0 and len(s["io"]) == 1 and \
        s["io"][0].startswith("I/O: native core") and \
        s["io"][0].endswith("streaming path")


def output_sig(paths: dict) -> tuple:
    with open(paths["json"]) as f:
        body = [ln for ln in f.read().split("\n")
                if not ln.startswith('\t"command": ')]
    return os.path.getsize(paths["bam"]), tuple(body)


def counters(program) -> dict:
    """Launches so far of each kernel in COUNTERS."""
    return {k: sum(getattr(program[m], n) for m, n in c)
            for k, c in COUNTERS.items()}


def seed_dir(cell, seed: int, bench_dir: str) -> str:
    return os.path.join(bench_dir, "cache", cell.config["name"],
                        cell.entry["traffic"], str(seed))


def start_sample(cell, seed: int, bench_dir: str = BENCH):
    """A child making the seed's sample, or None where it is cached."""
    out = seed_dir(cell, seed, bench_dir)
    if os.path.exists(os.path.join(out, "made.json")):
        return None
    return subprocess.Popen(
        [sys.executable, os.path.join(BENCH, "harness", "gen.py"),
         "--config", cell.config_path, "--traffic", cell.traffic_path,
         "--seed", str(seed), "--out", out,
         "--cache", os.path.join(bench_dir, "cache", cell.config["name"]),
         "--threads", str(max(2, (os.cpu_count() or 4) - 1))],
        stdout=subprocess.DEVNULL)


def stop(child) -> None:
    if child is not None and child.poll() is None:
        child.kill()
        child.wait()


def prune(cell, keep_dir: str, bench_dir: str) -> None:
    """Keep the KEEP_SEEDS most recently used samples of the cell."""
    os.utime(keep_dir)
    top = os.path.dirname(keep_dir)
    dirs = sorted((os.path.join(top, d) for d in os.listdir(top)),
                  key=os.path.getmtime, reverse=True)
    for d in dirs[KEEP_SEEDS:]:
        shutil.rmtree(d, ignore_errors=True)


def cached_reference(where: str, compute) -> tuple:
    """(record digests, report lines) of the reference over the sample in
    `where`, computed once per seed and kept beside it."""
    digests, report = os.path.join(where, "ref.digests"), os.path.join(where, "ref.json")
    if not (os.path.exists(digests) and os.path.exists(report)):
        recs, lines = compute()
        for path, data in ((report, json.dumps(lines).encode()),
                           (digests, b"".join(check.digests(recs)))):
            tmp = f"{path}.partial{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
    with open(digests, "rb") as f:
        raw = f.read()
    with open(report) as f:
        lines = json.load(f)
    n = check.DIGEST
    return [raw[i:i + n] for i in range(0, len(raw), n)], lines


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", entry=None, spec: dict | None = None,
             workers: int | None = None, t_start: float | None = None,
             bench_dir: str = BENCH, child="start") -> dict:
    """One run of a cell. Returns the result line's object, with the
    numbers compared under `checks`. `child` is the generator that
    start_sample started for this seed (None where it was cached)."""
    t_start = process_start() if t_start is None else t_start
    spec = cells.load_spec(ROOT) if spec is None else spec
    cell = cells.Cell(spec, workload, bench_dir)
    cfg = cell.config
    where = seed_dir(cell, seed, bench_dir)
    if child == "start":
        child = start_sample(cell, seed, bench_dir)
    with tempfile.TemporaryDirectory(prefix="gencore_bench_") as work:
        # 1. the sample, made in a child process while the program loads
        try:
            t0 = time.perf_counter()
            program, built = load_program(device)
            t_load = time.perf_counter() - t0
            if child is not None and child.wait(timeout=600) != 0:
                raise RuntimeError(f"the sample generator failed ({child.returncode})")
            t_made = time.perf_counter() - t0
        finally:
            stop(child)
        with open(os.path.join(where, "made.json")) as f:
            counts = json.load(f)["counts"]
        fasta, bed = gen.write_reference(cfg, os.path.join(bench_dir, "cache", cfg["name"]))
        sample = os.path.join(where, "sample.bam")
        paths = {"bam": os.path.join(work, "out.bam"),
                 "json": os.path.join(work, "out.json"),
                 "html": os.path.join(work, "out.html")}

        def argv(debug=False):
            return (["-i", sample, "-o", paths["bam"], "-r", fasta, "-b", bed,
                     "-j", paths["json"], "-h", paths["html"],
                     "--device", device] + cell.cli_args()
                    + (["--debug"] if debug else []))

        entry = program["cli"].main if entry is None else entry
        # 2. one warm-up call on the sample itself
        one = Sample(entry, argv(debug=trace))
        warm = one()
        log(f"set-up: program and kernels loaded in {t_load:.3f} s, sample "
            f"{'made' if child is not None else 'found'} by {t_made:.3f} s "
            f"({counts['reads']} reads), warm-up sample "
            f"{warm['t1'] - warm['t0']:.3f} s; {warm['io']}")
        if not streaming_ok(warm):
            raise RuntimeError("the warm-up sample failed or left the "
                               f"streaming path: {warm['io']} {warm['tail']}")
        program["sync"]()
        # 3. the window
        for attempt in (1, 2, 3):
            res = window(one, counts["reads"], seconds, trace, program, paths, work)
            if attempt == 1:
                setup_s = res["wall_window_start"] - t_start
            if not trace or not res["short"]:
                break
            log(f"trace lost kernel records (traced / launched: {res['short']})"
                + ("; profiling the window again" if attempt < 3 else
                   " after 3 windows"))
            if res["short"] == "marker" and attempt == 3:
                raise RuntimeError("three traced windows lost a marker")
        memory_peak = program["memory_peak"]()
        program.pop("cli", None)
        gc.collect()
        program["free"]()
        if loaded_forbidden():
            raise ForbiddenModules(loaded_forbidden())
        # 4. the reference, and the comparison
        workers = workers or os.cpu_count() or 1
        t_ref = time.perf_counter()
        ref_digests, ref_report = cached_reference(where, lambda: check.reference(
            sample, fasta, bed, cell.cli_args(),
            check.bed_starts(bed, gen.contig_names(cfg)), workers))
        out_records = check.output_records(paths["bam"])
        out_bases = res["samples_ok"] * sum(
            int.from_bytes(r[16:20], "little") for r in out_records)
        numbers, notes = check.compare(check.digests(out_records), ref_digests,
                                       check.report_body(paths["json"]),
                                       ref_report)
        numbers["samples_failed"] = res["failed"]
        ref_s = time.perf_counter() - t_ref
    prune(cell, where, bench_dir)
    log(f"window: {res['attempted']} samples, {res['window_s']:.3f} s, "
        f"per sample {[round(t, 3) for t in res['sample_s']]}; setup {setup_s:.3f} s; "
        f"kernels built in this run: {built or 'none'}; resident "
        f"{res['rss_start'] / 1e6:.0f} MB at the window's start, peak "
        f"{res['rss_peak'] / 1e6:.0f} MB")
    log("host over the window: " + samplers.host_line(res["host"]))
    out = {"correct": None, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": {},
           "device": program["device_info"](memory_peak)}
    if trace:
        top = sorted(res["stages"].items(), key=lambda kv: -kv[1])
        log("stage sums over the window (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in top if not k.startswith(("wire.", "out."))))
        log(f"kernels traced / launched: {res['kernel_counts']}")
        out["metrics"] = per_layer(cell, Context(
            res, res["samples_ok"] * counts["bases"], out_bases))
        out["device"]["busy_s"] = res["busy_s"]
        out["device"]["window_s"] = res["window_s"]
        out["breakdown"] = res["breakdown"]
    else:
        e2e = {"reads_per_s": (res["reads_done"] / res["window_s"], "reads/s"),
               "host_peak_rss_MB": (res["rss_peak"] / 1e6, "MB"),
               "setup_s": (setup_s, "s")}
        for m in cell.end_to_end():
            v, unit = e2e[m["name"]]
            out["metrics"][m["name"]] = {"value": v, "unit": unit}
    log(f"reference: {ref_s:.1f} s on {workers} processes")
    for n in notes:
        log("check:", n)
    # the numbers compared, each beside its limit: the last lines of the
    # log, and the last key of the result line
    out["correct"] = all(numbers[k] <= check.LIMITS[k] for k in check.LIMITS)
    out["checks"] = {k: {"value": numbers[k], "limit": check.LIMITS[k]}
                     for k in check.LIMITS}
    for k, v in out["checks"].items():
        log(f"compare {k}: {v['value']} (limit {v['limit']})")
    return out


class ForbiddenModules(RuntimeError):
    pass


def window(one: Sample, reads: int, seconds: float, trace: bool,
           program: dict, paths: dict, work: str) -> dict:
    """Samples back to back until `seconds` have passed."""
    sync = program["sync"]
    rss = samplers.RssPeak()
    rss_start = rss.peak
    stacks = samplers.Stacks(PROGRAM) if trace else None
    prof = program["profiler"]() if trace else contextlib.nullcontext()
    done, first_sig = [], None
    c0 = counters(program["mods"])
    rss.start()
    try:
        with prof, samplers.HostClock() as host:
            if stacks:
                stacks.start()
            t_marks = [program["marker"]()] if trace else []
            wall0 = time.time()
            t0 = time.perf_counter()
            h0 = h = host.read()
            while True:
                s = one()
                h1 = host.read()
                log(f"sample {len(done)}: " + samplers.host_line(host.delta(h, h1)))
                h = h1
                s["ok"] = streaming_ok(s)
                if s["ok"]:
                    sig = output_sig(paths)
                    first_sig = first_sig or sig
                    s["ok"] = sig == first_sig
                if not s["ok"]:
                    log(f"sample {len(done)} failed: rc {s['rc']} {s['io']}\n{s['tail']}")
                done.append(s)
                if s["t1"] - t0 >= seconds:
                    break
            t1 = done[-1]["t1"]
            host_window = host.delta(h0, h)
            if trace:
                t_marks.append(program["marker"]())
    finally:
        if stacks:
            stacks.stop()
        rss.stop()
    sync()
    c1 = counters(program["mods"])
    ok = [s for s in done if s["ok"]]
    res = {"attempted": len(done), "failed": len(done) - len(ok),
           "window_s": t1 - t0, "wall_window_start": wall0,
           "reads_done": len(ok) * reads, "rss_peak": rss.peak,
           "rss_start": rss_start, "host": host_window,
           "sample_s": [s["t1"] - s["t0"] for s in done], "samples_ok": len(ok),
           "stages": {}, "short": None}
    for s in ok:
        stages.add(res["stages"], s["stages"])
    if trace:
        path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(path)
        try:
            w = tr.Window(path, t_marks[0])
        except ValueError as e:        # a marker's record was dropped
            log(f"trace: {e}")
            res["short"] = "marker"
            return res
        finally:
            os.remove(path)
        res["kernel_counts"], res["short"] = kernel_counts(
            w, {k: c1[k] - c0[k] for k in c1})
        res["busy_s"] = w.busy_s()
        res["window"] = w
        res["breakdown"] = {"device_ops": [[n, t] for n, t in w.by_name()[:10]],
                            "idle_gaps": w.idle_gaps(stacks.label)}
    return res


def kernel_counts(w, launched: dict) -> tuple:
    """({kernel: [traced, launched]}, the kernels the trace holds fewer
    records of than the program launched, or None). Each kernel a roofline
    reads is held against its own counters, never against the trace's
    other kernels."""
    traced = Counter(tr.kernel_base(n) for _, n, _, _ in w.kernels())
    counts = {k: [traced[k], n] for k, n in launched.items() if traced[k] or n}
    return counts, {k: v for k, v in counts.items() if v[0] < v[1]} or None


def per_layer(cell, ctx) -> dict:
    """Each per-layer metric of the cell, from its reader; a reader that
    finds nothing leaves its metric out."""
    out = {}
    for m in cell.per_layer():
        v = cell.metric_module(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


class Context:
    """What a per-layer metric may read of a traced window: the stage sums,
    the device trace, and the bases of the input reads and of the output
    records of the window's samples."""

    def __init__(self, res: dict, in_bases: int, out_bases: int):
        self.reads = res["reads_done"]
        self.stages = res["stages"]
        self.window = res["window"]
        self.window_s = res["window_s"]
        self.busy_s = res["busy_s"]
        self.in_bases = in_bases
        self.out_bases = out_bases

    def stage_ms_per_mread(self, names) -> float | None:
        have = [n for n in names if n in self.stages]
        if not have or not self.reads:
            return None
        return 1e3 * sum(self.stages[n] for n in have) / (self.reads / 1e6)


def load_program(device: str) -> tuple:
    """Import the program, start its device and build or load its kernels.
    Returns (handles, names of the libraries built in this run)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    build_dir = os.path.join(ROOT, "build", PROGRAM)
    before = set(os.listdir(build_dir)) if os.path.isdir(build_dir) else set()
    from gencore_tpu_torch import cli
    from gencore_tpu_torch.core import kernels, vote
    from gencore_tpu_torch.io import native
    cuda = device.startswith("cuda")
    if native.get_lib() is None:
        raise RuntimeError(f"the program's native I/O core did not load: {native.why_not()}")
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        vote.build_library()
    after = set(os.listdir(build_dir)) if os.path.isdir(build_dir) else set()
    built = sorted(f for f in after - before if f.endswith(".so"))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def marker() -> float:
        # a short spin on an idle device: its start ties the trace's clock
        # to the host's
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return t

    def profiler():
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def device_info(peak: int) -> dict:
        if not cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}

    def free():
        if cuda:
            torch.cuda.empty_cache()

    return ({"cli": cli, "sync": sync, "marker": marker, "profiler": profiler,
             "device_info": device_info, "free": free,
             "memory_peak": (lambda: torch.cuda.max_memory_allocated()
                             if cuda else 0),
             "mods": {"core.vote": vote, "core.kernels": kernels}}, built)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = cells.load_spec(ROOT)
    cell = cells.Cell(spec, a.workload)
    child = start_sample(cell, a.seed)    # before torch, which takes seconds
    try:
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"this cell needs {cell.chips} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                       spec=spec, t_start=t_start, child=child)
    except ForbiddenModules as e:
        log(f"modules of the JAX package or JAX loaded in this process: {e}")
        return 3
    finally:
        stop(child)
    left = loaded_forbidden()
    if left:
        log(f"modules of the JAX package or JAX loaded in this process: {left}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
