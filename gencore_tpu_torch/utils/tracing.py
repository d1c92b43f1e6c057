"""The run's one recorder: stage totals, counters and spans, and an
optional device trace (port of gencore_tpu/utils/tracing.py, extended).

  * `StageTimer` accumulates wall time per named stage (`stage`) and sums
    per named counter (`count`); the CLI prints both under --debug, as
    `[stage]` and `[count]` lines (the JAX package's class, with counters);
  * spans: while recording is on, every `StageTimer.stage` and every
    `span()` also records one `Span` (its id, the id of the span open
    around it, the run's sample id, the coordinate window, the thread,
    its name, start and end on `time.perf_counter_ns`, the thread's CPU
    nanoseconds in it, and a few attributes), kept in memory (the newest
    MAX_SPANS) until `take()` hands them over. A stage's total is the sum
    of its spans' durations: both come from the same clock readings.
    Recording is off by default, and then costs one check of `RECORDING`
    a stage; it is on inside `recording(True)` (the CLI under --debug or
    with GENCORE_TRACE_DIR) and after `enable()`;
  * set GENCORE_TRACE_DIR to capture a torch.profiler trace (CPU ops, plus
    CUDA kernels on a CUDA run) of the traced region, written there as a
    Chrome trace (`trace.json`) with a kernel-time table (`kernels.txt`),
    and the region's spans as a Chrome trace of their own (`spans.json`),
    shifted onto the profiler's clock (`clock_map`, through one
    `gencore.clock` event) so that the two files load aligned (Perfetto,
    chrome://tracing).

Threads: a thread that works for a run takes its starter's context
(`context()` in the starter, `adopt()` in the thread), so that its spans
carry the run's sample id and hang under the span that started it;
`set_window(w)` marks the spans a thread opens next with window w.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

RECORDING = False    # spans are recorded while this is True
MAX_SPANS = 1 << 17  # the newest spans kept; older ones are dropped


class Span(NamedTuple):
    id: int
    parent: int       # 0: no span was open around it
    sample: int       # one per `sample()` (a CLI run); -1 outside one
    window: int       # the coordinate window, or -1
    thread: str
    name: str
    t0_ns: int        # time.perf_counter_ns() at its start and end
    t1_ns: int
    cpu_ns: int       # the thread's CPU time within it
    attrs: dict | None


_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_SAMPLES = itertools.count(1)
_local = threading.local()


class _State:
    """One thread's open spans, sample and window."""

    __slots__ = ("stack", "sample", "base", "window", "thread")

    def __init__(self):
        self.stack = []
        self.sample = -1
        self.base = 0          # the parent of the thread's outermost span
        self.window = -1
        self.thread = threading.current_thread().name


def _state() -> _State:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _State()
    return st


def _open(name: str, attrs):
    st = _state()
    t0 = time.perf_counter_ns()
    rec = [next(_IDS), st.stack[-1][0] if st.stack else st.base, name, t0,
           time.thread_time_ns(), attrs, st.window]
    st.stack.append(rec)
    return rec


def _close(rec, t1: int) -> None:
    cpu = time.thread_time_ns() - rec[4]
    st = _state()
    if st.stack and st.stack[-1] is rec:
        st.stack.pop()
    else:
        st.stack.remove(rec)
    _SPANS.append(Span(rec[0], rec[1], st.sample, rec[6], st.thread, rec[2],
                       rec[3], t1, cpu, rec[5]))


@contextlib.contextmanager
def _span(name: str, attrs):
    rec = _open(name, attrs)
    try:
        yield
    finally:
        _close(rec, time.perf_counter_ns())


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A span of the work in its block (recorded only while recording is
    on); attrs, small numbers such as a launch's shape, go with it."""
    if not RECORDING:
        return _OFF
    return _span(name, attrs or None)


def enable() -> None:
    global RECORDING
    RECORDING = True


def disable() -> None:
    global RECORDING
    RECORDING = False


@contextlib.contextmanager
def recording(on: bool = True):
    """Recording on within the block where `on` (it stays on where it
    already was); the previous state after it."""
    global RECORDING
    was = RECORDING
    RECORDING = was or bool(on)
    try:
        yield
    finally:
        RECORDING = was


def take() -> list:
    """The recorded spans, oldest first; the recorder keeps none of them."""
    out = []
    while True:
        try:
            out.append(_SPANS.popleft())
        except IndexError:
            return out


def spans() -> list:
    """The recorded spans, oldest first, left in the recorder."""
    return list(_SPANS)


@contextlib.contextmanager
def sample(name: str = "cli.sample"):
    """The root span of one run: its spans, and those of the threads that
    adopt its context, share a new sample id."""
    if not RECORDING:
        yield
        return
    st = _state()
    saved = st.sample, st.base, st.window
    st.sample, st.base, st.window = next(_SAMPLES), 0, -1
    try:
        with _span(name, None):
            yield
    finally:
        st.sample, st.base, st.window = saved


def context():
    """The calling thread's sample id and innermost open span, for a
    thread it starts to `adopt`; None while recording is off."""
    if not RECORDING:
        return None
    st = _state()
    return st.sample, st.stack[-1][0] if st.stack else st.base


def adopt(ctx) -> None:
    """Make this thread's spans part of the run `ctx` (from `context()`)
    came from, hung under the span open there."""
    if ctx is not None:
        st = _state()
        st.sample, st.base = ctx
        st.window = -1


def set_window(w: int) -> None:
    """Spans this thread opens from now on belong to coordinate window w
    (-1: to none)."""
    if RECORDING:
        _state().window = w


class StageTimer:
    """Totals and call counts of named stages, and sums of named counters
    (bytes, records): the figures of the --debug tables."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}
        self.counters: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        rec = _open(name, None) if RECORDING else None
        t0 = time.perf_counter_ns() if rec is None else rec[3]
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            if rec is not None:
                _close(rec, t1)
            self.totals[name] = self.totals.get(name, 0.0) + (t1 - t0) / 1e9
            self.counts[name] = self.counts.get(name, 0) + 1

    def count(self, name: str, n) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def merge_into(self, stage_totals: dict | None,
                   count_totals: dict | None) -> None:
        """Add this timer's stage totals and counters to the run's sums
        (either may be None: not kept)."""
        for into, part in ((stage_totals, self.totals),
                           (count_totals, self.counters)):
            if into is not None:
                for k, v in part.items():
                    into[k] = into.get(k, 0) + v

    def report_lines(self) -> list:
        total = sum(self.totals.values())
        lines = [f"stage timings (total {total:.3f}s):"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"  {name:<22} {t:8.3f}s {pct:5.1f}%  "
                         f"x{self.counts.get(name, 0)}")
        lines += count_lines(self.counters)
        return lines


def count_lines(counters: dict) -> list:
    """The `[count] <name>: <n>` lines of a run's counters."""
    return [f"[count] {k}: {v:.3f}" if isinstance(v, float)
            else f"[count] {k}: {v}" for k, v in sorted(counters.items())]


def chrome_events(spans_: list, t_clock_ns: int, clock_ts_us: float,
                  pid: int) -> list:
    """Chrome-trace events of spans: one complete ("X") event a span, on
    the clock whose time clock_ts_us (microseconds) is perf_counter_ns
    t_clock_ns, one tid a thread (named by "M" events), the span's ids,
    window, CPU microseconds and attributes under args."""
    tids: dict = {}
    out = []
    for s in spans_:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        args = {"id": s.id, "parent": s.parent, "sample": s.sample,
                "window": s.window, "cpu_us": s.cpu_ns / 1e3}
        if s.attrs:
            args.update(s.attrs)
        out.append({"ph": "X", "name": s.name, "pid": pid, "tid": tid,
                    "ts": clock_ts_us + (s.t0_ns - t_clock_ns) / 1e3,
                    "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": args})
    out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": name}} for name, tid in tids.items()]
    return out


def clock_map(trace: dict, t_clock: int, unix_clock: int):
    """The time (us) on a profiler trace's clock of perf_counter_ns 0,
    from the `gencore.clock` event, within which perf_counter_ns read
    t_clock and time.time_ns unix_clock. The profiler's clock is Unix
    time since the trace's baseTimeNanoseconds, so the two readings map
    perf_counter onto it to within their own gap; a trace without that
    base is tied at the event's start instead (off by at most the event's
    length). None without the event."""
    ev = [e for e in trace.get("traceEvents", [])
          if e.get("name") == "gencore.clock" and "ts" in e]
    if not ev:
        return None
    base = trace.get("baseTimeNanoseconds")
    if base is None:
        return float(ev[0]["ts"]) - t_clock / 1e3
    return (unix_clock - t_clock - int(base)) / 1e3


@contextlib.contextmanager
def maybe_trace():
    trace_dir = os.environ.get("GENCORE_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with recording(True):
        t_start = time.perf_counter_ns()
        with profile(activities=acts) as prof:
            # the tie between the two clocks: a profiler event around a
            # reading of each
            with record_function("gencore.clock"):
                t_clock = time.perf_counter_ns()
                unix_clock = time.time_ns()
            yield
    trace_path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(trace_path)
    sort = ("self_device_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(trace_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))
    with open(trace_path) as f:
        zero = clock_map(json.load(f), t_clock, unix_clock) or 0.0
    mine = [s for s in spans() if s.t0_ns >= t_start]
    events = chrome_events(mine, t_clock, zero + t_clock / 1e3, os.getpid())
    events.append({"ph": "i", "s": "p", "name": "gencore.clock",
                   "pid": os.getpid(), "tid": 0, "ts": zero + t_clock / 1e3})
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump({"traceEvents": events,
                   "clock": {"perf_counter_ns": t_clock,
                             "ts_us": zero + t_clock / 1e3}}, f)
