"""The program's memory gauge in the traced window, for the per-layer
memory metrics: what held the process's memory at the reading of its
highest resident set.

The program (`gencore_tpu_torch/utils/tracing.py`) runs its gauge while a
CLI run made with --debug runs, as the traced run's samples are. Every
50 ms it reads the resident set (`rss`, /proc/self/statm as
`samplers.rss_bytes` reads it); where that has passed its last whole
reading by 0.5%, and once before and once after each CLI run, it takes
a whole reading: also the mapped files resident (`file`),
the anonymous memory (`anon`), glibc's heap in use and held free
(`heap_used`, `heap_free`), the pinned host blocks (`pinned`) and the
device memory reserved (not host memory). A reading of the resident set
alone leaves those None, and so may a kernel that does not split it
(`file`, `anon`) or a C library without mallinfo2 (`heap_*`). All are on
`time.perf_counter_ns` (the clock of the window's markers). They are read
here after the window: those taken at or after the window's first marker.
A program without the gauge, or with no reading in the window, gives
None, and so does every metric that reads it.

The metrics read the window's whole reading of the highest resident set
(within 0.5% of the window's highest reading). There the resident set
splits into five holders that add up to it (to within the gap between
the /proc reads), less what falls outside them where `other` would be
negative and is taken as 0 (glibc counts free heap that is not
resident): file, pinned, heap_used, heap_free, and
other = anon - heap_used - heap_free - pinned.
"""

from __future__ import annotations

import sys

from harness import spans

RECORDER = spans.RECORDER
HOLDERS = ("file", "pinned", "heap_used", "heap_free", "other")
MB = 1e6          # as host_peak_rss_MB


def of(ctx):
    """The gauge's readings in the traced window (`ctx.gauges` where the
    harness hands them over, else the program's recorder's since the
    window's first marker), or None where there are none."""
    got = getattr(ctx, "gauges", None)
    if got is None:
        recorded = getattr(sys.modules.get(RECORDER), "gauges", None)
        window = getattr(ctx, "window", None)
        if recorded is None or window is None:
            return None
        lo = window.host_t0 * 1e9
        got = [g for g in recorded() if g.t_ns >= lo]
    return got or None


def peak(ctx):
    """The window's whole reading (one that split the resident set) of
    the highest resident set, or None."""
    got = of(ctx)
    if got is None:
        return None
    whole = [g for g in got if g.file is not None]
    return max(whole, key=lambda g: g.rss) if whole else None


def split(g) -> dict:
    """{holder: bytes} at reading g; a heap holder is None where glibc
    gave no heap figures."""
    heap = (g.heap_used or 0) + (g.heap_free or 0)
    return {"file": g.file, "pinned": g.pinned, "heap_used": g.heap_used,
            "heap_free": g.heap_free,
            "other": max(0, g.anon - heap - g.pinned)}


def at_peak_mb(ctx, holder: str):
    """MB of `holder` (one of HOLDERS) at the window's peak reading, or
    None."""
    g = peak(ctx)
    if g is None:
        return None
    v = split(g)[holder]
    return None if v is None else v / MB
