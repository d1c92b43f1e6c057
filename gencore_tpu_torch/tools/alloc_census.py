"""Where the streaming path's host memory goes, stage by stage.

    python -m gencore_tpu_torch.tools.alloc_census [--scale N]
        [--fragments N] [--device cuda|cpu] [--workdir DIR]

Runs the deep panel (`workloads.deep_panel`, 40,000 x scale fragments)
through `parallel.streaming.run_streaming` once, in this process, with
every `StageTimer` stage wrapped, and prints one JSON line:

  * `stages`: per stage and window, in the order they ended, the growth of
    glibc's arenas and of the C heap in use across the stage (mallinfo2),
    and of what tracemalloc traces (Python and numpy, not torch); a
    "window" numbers each StageTimer in the order it first ran: the run's
    own (`index`) and its writer's (`write.deflate`) come before the
    windows' engines;
  * `numpy_over_1mb`: the traced allocations of 1 MB or more that a stage
    left alive, by the line that made them;
  * `torch_peak`: the largest live total of torch's CPU allocations
    (torch.profiler's memory events), the operator running then, and the
    sizes of the blocks of 1 MB or more alive at that moment.

On the CPU this finds which per-window buffers fill the arenas
(ROADMAP queue 3). The profiler and tracemalloc slow the run; its time is
not a measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import sys
import threading
import tracemalloc

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MB = 1 << 20


class _MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def _heap():
    """(arena MB, in use MB) of glibc's heap."""
    f = ctypes.CDLL(None).mallinfo2
    f.restype = _MallInfo2
    m = f()
    return m.arena / MB, (m.uordblks + m.hblkhd) / MB


def _torch_peak(events):
    """The largest live total of torch's CPU allocations in a Chrome
    trace's events, the operator that encloses it, and the live blocks
    of 1 MB or more then."""
    mem = sorted((e for e in events if e.get("name") == "[memory]"),
                 key=lambda e: e["ts"])
    if not mem:
        return None
    best = max(mem, key=lambda e: e["args"].get("Total Allocated", 0))
    live = {}
    for e in mem:
        if e["ts"] > best["ts"]:
            break
        a = e["args"]
        if a.get("Bytes", 0) > 0:
            live[a.get("Addr")] = a["Bytes"]
        else:
            live.pop(a.get("Addr"), None)
    ops = [e["name"] for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and e["ts"] <= best["ts"] <= e["ts"] + e.get("dur", 0)]
    big = sorted((b for b in live.values() if b >= MB), reverse=True)
    return {"total_mb": best["args"]["Total Allocated"] / MB,
            "in_op": ops[-1] if ops else None,
            "blocks_over_1mb": len(big),
            "block_mb": sorted({round(b / MB, 2) for b in big},
                               reverse=True)}


def census(scale=1, device="cuda", fragments=None, workdir=None):
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gencore_tpu_torch.device import resolve_device
    from gencore_tpu_torch.io.fasta import FastaRef
    from gencore_tpu_torch.options import Options
    from gencore_tpu_torch.parallel.streaming import run_streaming
    from gencore_tpu_torch.tools import measure_rss, workloads
    from gencore_tpu_torch.utils import tracing

    n_frag = fragments or workloads.DEEP_PANEL_FRAGMENTS * scale
    bam, fa = workloads.deep_panel(workdir or measure_rss.WORKLOAD_DIR,
                                   n_fragments=n_frag)
    stages, numpy_big = [], []
    lock = threading.Lock()
    windows = {}
    orig = tracing.StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name):
        a0, u0 = _heap()
        t0, _ = tracemalloc.get_traced_memory()
        snap = tracemalloc.take_snapshot()
        with orig(self, name):
            yield
        a1, u1 = _heap()
        t1, _ = tracemalloc.get_traced_memory()
        grown = [(str(s.traceback[-1]), s.size_diff / MB)
                 for s in tracemalloc.take_snapshot().compare_to(
                     snap, "lineno")
                 if s.size_diff >= MB
                 and s.traceback[-1].filename != tracemalloc.__file__]
        with lock:
            w = windows.setdefault(id(self), len(windows))
            stages.append({"window": w, "stage": name,
                           "arena_growth_mb": a1 - a0,
                           "in_use_growth_mb": u1 - u0,
                           "traced_growth_mb": (t1 - t0) / MB,
                           "arena_mb": a1})
            numpy_big.extend({"window": w, "stage": name, "line": line,
                              "mb": mb} for line, mb in grown)

    opt = Options()
    out = os.path.join(os.path.dirname(bam), "census_out.bam")
    opt.input, opt.output, opt.ref_file = bam, out, fa
    tracemalloc.start(1)
    tracing.StageTimer.stage = stage
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            run_streaming(opt, bam, out, fasta=FastaRef.load(fa),
                          device=resolve_device(device))
    finally:
        tracing.StageTimer.stage = orig
        tracemalloc.stop()
    trace = os.path.join(os.path.dirname(bam), "census_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(trace)
    os.remove(out)
    arena, in_use = _heap()
    return {"scale": scale, "fragments": n_frag, "device": device,
            "stages": stages, "numpy_over_1mb": numpy_big,
            "torch_peak": _torch_peak(events),
            "end_arena_mb": arena, "end_in_use_mb": in_use}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--fragments", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    a = ap.parse_args(argv)
    print(json.dumps(census(a.scale, a.device, a.fragments, a.workdir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
