"""The program's spans in the traced window, for the per-layer metrics that
read them, and the window's idle gaps named by the spans the program's
threads had open.

The program (`gencore_tpu_torch/utils/tracing.py`) records a span, in
memory, for each stage, wait and launch of a CLI run made with --debug,
as the traced run's samples are: its name, thread, start and end on
`time.perf_counter_ns` (the clock of the window's markers, onto which
`trace.Window.offset` maps the device's times) and the thread's CPU time
in it. They are read here after the window: those that started at or
after the window's first marker. A program without that recorder, or
with no span in the window, gives None, and so does every metric that
reads spans.
"""

from __future__ import annotations

import sys

from harness import trace

RECORDER = "gencore_tpu_torch.utils.tracing"
# the leaf stages of the windows' host work on the dispatch and collector
# threads (engine.py run_dispatch, run_collect)
HOST_LEAVES = ("sort", "umi", "grouping", "materialize.host", "election",
               "assemble", "finalize", "vote.sync")


def of(ctx):
    """The spans of the traced window (`ctx.spans` where the harness hands
    them over, else the program's recorder's since the window's first
    marker), or None where there are none."""
    got = getattr(ctx, "spans", None)
    if got is None:
        recorded = getattr(sys.modules.get(RECORDER), "spans", None)
        window = getattr(ctx, "window", None)
        if recorded is None or window is None:
            return None
        lo = window.host_t0 * 1e9
        got = [s for s in recorded() if s.t0_ns >= lo]
    return got or None


def wall_s(spans, names) -> float:
    """Summed wall seconds of the spans named in names."""
    names = set(names)
    return sum(s.t1_ns - s.t0_ns for s in spans if s.name in names) / 1e9


def ms_per_mread(ctx, names):
    """Summed wall milliseconds of the spans named in names, per million
    input reads of the window's samples; None without such spans."""
    sp = of(ctx)
    if sp is None or not ctx.reads or not any(s.name in names for s in sp):
        return None
    return 1e3 * wall_s(sp, names) / (ctx.reads / 1e6)


def share_of_pass2_pct(ctx, names):
    """100 x the summed wall of the spans named in names over the summed
    wall of pass 2 (`stream.windows`) of the window's samples."""
    sp = of(ctx)
    if sp is None:
        return None
    whole = wall_s(sp, ["stream.windows"])
    if whole <= 0:
        return None
    return 100.0 * wall_s(sp, names) / whole


def offcpu_pct(ctx, names=HOST_LEAVES):
    """100 x (1 - the threads' CPU seconds over the wall seconds) summed
    over the spans named in names."""
    sp = of(ctx)
    if sp is None:
        return None
    mine = [s for s in sp if s.name in set(names)]
    wall = sum(s.t1_ns - s.t0_ns for s in mine)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s.cpu_ns for s in mine) / wall)


def _thread(name: str) -> str:
    return "main" if name == "MainThread" else name


def open_over(spans, h0: float, h1: float) -> str:
    """Each thread's innermost span open over most of [h0, h1] (host
    seconds), as `thread:name`, followed, where that span's children
    fill part of the gap, by `>child seconds` of the child that fills
    most of it; joined by ` | `, `no span` where no thread had one."""
    a, b = h0 * 1e9, h1 * 1e9

    def over(s):
        return min(s.t1_ns, b) - max(s.t0_ns, a)

    def dur(s):
        return s.t1_ns - s.t0_ns

    best = {}
    for s in spans:
        if over(s) > (b - a) / 2:
            t = _thread(s.thread)
            # nested spans: the innermost one is the shortest
            if t not in best or dur(s) < dur(best[t]):
                best[t] = s
    out = []
    for t in sorted(best):
        s = best[t]
        kids = [(over(k), k.name) for k in spans
                if k.parent == s.id and k.thread == s.thread and over(k) > 0]
        top = max(kids, default=None)
        out.append(f"{t}:{s.name}" + (f">{top[1]} {top[0] / 1e9:.3f}s"
                                      if top else ""))
    return " | ".join(out) or "no span"


def idle_spans(window, spans, top: int = 10) -> list:
    """The window's longest idle gaps of the device (the gaps of
    `trace.Window.idle_gaps`), each named by the spans its threads had
    open over most of it: [[label @start, seconds], ...]."""
    iv = [(a, b) for _, _, a, b in window.ops]
    out = []
    for a, b in trace.gaps(iv, window.lo_us, window.hi_us)[:top]:
        h0, h1 = a / 1e6 - window.offset, b / 1e6 - window.offset
        out.append([f"{open_over(spans, h0, h1)} @{h0 - window.host_t0:.3f}s",
                    (b - a) / 1e6])
    return out
