"""Host and device residency of the in-memory window pipeline against the
bounded-memory streaming path (port of tools/measure_rss.py).

Runs the same deep-panel workload (`workloads.deep_panel`, 40,000 x scale
fragments, ~6 reads each) through (a) the in-memory window pipeline,
`parallel.pipeline.run_pipelined`, each window written as it retires by
the native core's StreamingBamWriter, and (b) `parallel.streaming.
run_streaming`, each in a fresh subprocess on `--device`, and reports for
each: the peak resident set (VmHWM from /proc/self/status, or where the
kernel does not report VmHWM the largest resident set sampled every 10 ms;
`peak_rss_from` says which; null when neither is there; the sampled peak
is also given alone), the tracemalloc peak (Python and numpy allocations;
tensors allocated by torch are not seen) and, on CUDA,
torch.cuda.max_memory_allocated / max_memory_reserved and, where this
torch has torch.cuda.host_memory_stats, the pinned host allocator's
blocks (`host_pinned`); and glibc's heap at the end of the run
(`malloc_end_mb`, from mallinfo2). The streaming run
holds one coordinate window and the per-record index, not the file, so
its peak resident set should stay near flat as the input grows; the two
outputs must hold the same records (compared decoded, not as compressed
bytes).

    python -m gencore_tpu_torch.tools.measure_rss [--scale N]
        [--fragments N] [--device cuda|cpu] [--workdir DIR]

Prints one JSON line. `--fragments` overrides 40,000 x scale.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKLOAD_DIR = os.path.join(REPO, "build", "workloads")
MB = 1 << 20

CHILD = r"""
import json, os, sys, threading, time, tracemalloc
sys.modules["jax"] = None
sys.modules["gencore_tpu"] = None
tracemalloc.start()

# the resident set sampled every 10 ms (/proc/self/statm), for kernels
# whose /proc/self/status has no VmHWM; getrusage's ru_maxrss is no
# substitute: it carries the parent's peak over fork and exec
PAGE_KB = os.sysconf("SC_PAGE_SIZE") // 1024
sampled = [0]
stop = threading.Event()


def rss_kb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE_KB


def sample():
    while True:
        try:
            sampled[0] = max(sampled[0], rss_kb())
        except (OSError, ValueError, IndexError):
            return
        if stop.wait(0.01):
            return


sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
import torch
from gencore_tpu_torch.device import resolve_device
from gencore_tpu_torch.io.fasta import FastaRef
from gencore_tpu_torch.options import Options

mode, bam, fa, out, device = sys.argv[1:6]
dev = resolve_device(device)
t0 = time.perf_counter()
fasta = FastaRef.load(fa)
opt = Options()
opt.input, opt.output, opt.ref_file = bam, out, fa
if mode == "streaming":
    from gencore_tpu_torch.parallel.streaming import run_streaming
    run_streaming(opt, bam, out, fasta=fasta, device=dev)
else:
    from gencore_tpu_torch.io import bam as bamio
    from gencore_tpu_torch.io import native
    from gencore_tpu_torch.parallel import pipeline
    from gencore_tpu_torch.parallel.streaming import StreamingBamWriter
    if native.get_lib() is None:
        sys.exit("in_memory mode needs the native core: " + native.why_not())
    rdr = bamio.BamReader(bam)
    batch = rdr.read_all()
    w = StreamingBamWriter(out, rdr.header)
    pipeline.run_pipelined(opt, batch, rdr.header, fasta=fasta, device=dev,
                           out_writer=w)
    w.close()
if dev.type == "cuda":
    torch.cuda.synchronize(dev)
seconds = time.perf_counter() - t0
stop.set()
sampler.join()
kb, source = None, None
with open("/proc/self/status") as f:
    for line in f:
        if line.startswith("VmHWM:"):
            kb, source = int(line.split()[1]), "VmHWM"
if kb is None and sampled[0]:
    kb, source = sampled[0], "VmRSS sampled every 10 ms"
_cur, peak = tracemalloc.get_traced_memory()
res = {"mode": mode, "seconds": seconds,
       "peak_rss_mb": None if kb is None else kb / 1024,
       "peak_rss_from": source,
       "sampled_rss_peak_mb": sampled[0] / 1024 if sampled[0] else None,
       "tracemalloc_peak_mb": peak / (1 << 20)}
# the C heap at the end of the run (glibc's mallinfo2, summed over its
# arenas): what the native core, torch's CPU allocator and numpy's C side
# hold or keep cached, none of which tracemalloc sees
try:
    import ctypes

    class MallInfo2(ctypes.Structure):
        _fields_ = [(n, ctypes.c_size_t) for n in (
            "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
            "fsmblks", "uordblks", "fordblks", "keepcost")]

    mallinfo2 = ctypes.CDLL(None).mallinfo2
    mallinfo2.restype = MallInfo2
    mi = mallinfo2()
    res["malloc_end_mb"] = {"arenas": mi.arena / (1 << 20),
                            "mmapped": mi.hblkhd / (1 << 20),
                            "in_use": (mi.uordblks + mi.hblkhd) / (1 << 20),
                            "free_in_arenas": mi.fordblks / (1 << 20)}
except (OSError, AttributeError):
    res["malloc_end_mb"] = None
if dev.type == "cuda":
    res["cuda_max_allocated_mb"] = (torch.cuda.max_memory_allocated(dev)
                                    / (1 << 20))
    res["cuda_max_reserved_mb"] = (torch.cuda.max_memory_reserved(dev)
                                   / (1 << 20))
    # torch's caching allocator of pinned host blocks (device->host
    # downloads): resident, and not seen by tracemalloc
    stats = getattr(torch.cuda, "host_memory_stats", None)
    res["host_pinned"] = None if stats is None else {
        k: v for k, v in stats().items()
        if k.split(".")[0] in ("allocated_bytes", "active_bytes",
                               "allocations", "num_host_alloc",
                               "num_host_free")}
print(json.dumps(res))
"""


def run_mode(mode: str, bam: str, fa: str, out: str, device: str) -> dict:
    """One fresh process running `mode` ("in_memory" or "streaming")."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    cp = subprocess.run([sys.executable, "-c", CHILD, mode, bam, fa, out,
                         device], capture_output=True, text=True, env=env,
                        cwd=REPO, timeout=3000)
    if cp.returncode != 0:
        raise RuntimeError(f"{mode} run failed: {cp.stderr[-2000:]}")
    return json.loads(cp.stdout.strip().splitlines()[-1])


def measure(scale: int = 1, device: str = "cuda", fragments: int = None,
            workdir: str = WORKLOAD_DIR) -> dict:
    """Both modes on the deep panel of 40,000 x scale fragments (or
    `fragments`), made or reused under workdir; returns the JSON dict."""
    from gencore_tpu_torch.io import native
    from gencore_tpu_torch.tools import workloads
    from gencore_tpu_torch.tools.make_golden import digest_records
    n_frag = fragments or workloads.DEEP_PANEL_FRAGMENTS * scale
    bam, fa = workloads.deep_panel(workdir, n_fragments=n_frag)
    bt = native.bgzf_block_table(bam) if native.get_lib() else None
    res = {"scale": scale, "fragments": n_frag, "device": device,
           "input_mb": os.path.getsize(bam) / MB,
           "payload_mb": None if bt is None else bt[1] / MB}
    digests = {}
    for mode in ("in_memory", "streaming"):
        out = os.path.join(workdir, f"rss_{mode}_{n_frag}.bam")
        r = run_mode(mode, bam, fa, out, device)
        for k, v in r.items():
            if k != "mode":
                res[f"{mode}_{k}"] = v
        digests[mode] = digest_records(out)
        os.remove(out)
    res["output_records"] = digests["streaming"][0]
    res["outputs_identical"] = digests["in_memory"] == digests["streaming"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--fragments", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=WORKLOAD_DIR)
    a = ap.parse_args(argv)
    res = measure(a.scale, a.device, a.fragments, a.workdir)
    print(json.dumps(res))
    return 0 if res["outputs_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
