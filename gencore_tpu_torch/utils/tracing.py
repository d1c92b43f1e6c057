"""Per-stage timing and an optional device trace of a run (port of
gencore_tpu/utils/tracing.py).

  * `StageTimer` accumulates wall time per named stage; the CLI prints the
    table under --debug (the JAX package's class, copied);
  * set GENCORE_TRACE_DIR to capture a torch.profiler trace (CPU ops, plus
    CUDA kernels on a CUDA run) of the traced region, written there as a
    Chrome trace (`trace.json`) with a kernel-time table (`kernels.txt`).
"""

from __future__ import annotations

import contextlib
import os
import time


class StageTimer:
    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report_lines(self) -> list:
        total = sum(self.totals.values())
        lines = [f"stage timings (total {total:.3f}s):"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            # wire.* totals are byte counts the engine adds without a stage
            lines.append(f"  {name:<22} {t:8.3f}s {pct:5.1f}%  "
                         f"x{self.counts.get(name, 0)}")
        return lines


@contextlib.contextmanager
def maybe_trace():
    trace_dir = os.environ.get("GENCORE_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    sort = ("self_device_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(trace_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))
