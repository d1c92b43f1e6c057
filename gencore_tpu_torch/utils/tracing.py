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
  * the memory gauge: while a sample runs with recording on, the thread
    `gencore-mem` reads the resident set every GAUGE_PERIOD_S and what
    holds it (mapped files; anonymous memory; glibc's heap in use and
    held free; pinned host blocks; device memory reserved) wherever it
    climbed by WHOLE_STEP; `sample()` reads all of it once before its
    root span opens and once after it closes, so no span holds a reading.
    One `Gauge` a reading, on the spans' clock, kept in memory (the
    newest MAX_GAUGES) until `take("gauges")` hands them over; `Peak`,
    from `sample()`, is a sample's highest. With recording off no thread
    starts and nothing is read;
  * set GENCORE_TRACE_DIR to capture a torch.profiler trace (CPU ops, plus
    CUDA kernels on a CUDA run) of the traced region, written there as a
    Chrome trace (`trace.json`) with a kernel-time table (`kernels.txt`),
    and the region's spans and gauge readings as a Chrome trace of their
    own (`spans.json`: "X" events and "C" counter events), shifted onto
    the profiler's clock (`clock_map`, through one `gencore.clock` event)
    so that the two files load aligned (Perfetto, chrome://tracing);
  * `annotate()` adds attributes to the innermost span open on the
    calling thread: the CLI puts a windowed run's counter totals on its
    `cli.sample` span.

Threads: a thread that works for a run takes its starter's context
(`context()` in the starter, `adopt()` in the thread), so that its spans
carry the run's sample id and hang under the span that started it;
`set_window(w)` marks the spans a thread opens next with window w.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import json
import os
import re
import sys
import threading
import time
from typing import NamedTuple

RECORDING = False    # spans are recorded while this is True
MAX_SPANS = 1 << 17  # the newest spans kept; older ones are dropped
MAX_GAUGES = 1 << 16  # the newest gauge readings kept (55 min at 50 ms)
# The gauge's thread wakes every GAUGE_PERIOD_S, and each wake takes the
# interpreter lock from the program's threads. On an H100 host a 10 ms
# period lengthened a sample by 10-14% against the gauge off (one
# process, one seed, alternating); 50 ms stayed inside the samples'
# noise and still found each sample's highest resident set to 0.7%.
GAUGE_PERIOD_S = 0.05


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


class Gauge(NamedTuple):
    """One reading of what holds the process's memory, in bytes."""
    t_ns: int             # time.perf_counter_ns() of the reading
    rss: int              # resident pages (/proc/self/statm)
    file: int | None      # RssFile: mapped files (libraries) resident
    anon: int | None      # RssAnon + RssShmem
    heap_used: int | None  # glibc mallinfo2 uordblks + hblkhd
    heap_free: int | None  # fordblks (both None without mallinfo2)
    pinned: int | None    # pinned host blocks (0 without CUDA)
    device_reserved: int | None  # torch.cuda.memory_reserved(): device
    # A reading of the resident set alone leaves every field after rss
    # None (see WHOLE_STEP).


_SPANS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_GAUGES: collections.deque = collections.deque(maxlen=MAX_GAUGES)
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


def annotate(**attrs) -> None:
    """Add attrs to the innermost span open on this thread (while
    recording is on)."""
    if not RECORDING:
        return
    st = _state()
    if st.stack:
        rec = st.stack[-1]
        rec[5] = {**(rec[5] or {}), **attrs}


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


def take(what: str = "spans") -> list:
    """The recorded spans (`what="gauges"`: the gauge's readings), oldest
    first; the recorder keeps none of them."""
    q = {"spans": _SPANS, "gauges": _GAUGES}[what]
    out = []
    while True:
        try:
            out.append(q.popleft())
        except IndexError:
            return out


def spans() -> list:
    """The recorded spans, oldest first, left in the recorder."""
    return list(_SPANS)


def gauges() -> list:
    """The gauge's readings, oldest first, left in the recorder."""
    return list(_GAUGES)


@contextlib.contextmanager
def sample(name: str = "cli.sample"):
    """The root span of one run: its spans, and those of the threads that
    adopt its context, share a new sample id. The gauge runs around it,
    with one whole reading before the span opens and one after it closes.
    Yields the sample's `Peak` (filled when the block ends), or None while
    recording is off."""
    if not RECORDING:
        yield None
        return
    peak, t_on = Peak(), time.perf_counter_ns()
    _gauge_on()
    st = _state()
    saved = st.sample, st.base, st.window
    st.sample, st.base, st.window = next(_SAMPLES), 0, -1
    rec = _open(name, None)
    try:
        yield peak
    finally:
        _close(rec, time.perf_counter_ns())
        _gauge_off()
        peak.fill(st.sample, rec[3], t_on, time.perf_counter_ns())
        st.sample, st.base, st.window = saved


# the memory gauge

_PAGE = os.sysconf("SC_PAGE_SIZE")
_STATUS_RSS = re.compile(rb"^(RssAnon|RssFile|RssShmem):\s+(\d+)", re.M)
_STATUS_KEYS = {b"RssAnon": "anon", b"RssFile": "file", b"RssShmem": "anon"}
# each mapping's path (empty for an anonymous one), Rss and Anonymous
_SMAPS_VMA = re.compile(rb"^[0-9a-f]+-[0-9a-f]+ \S+ \S+ \S+ \S+ *([^\n]*)\n"
                        rb"(?:(?!Rss:)[^\n]*\n)*Rss: +(\d+) kB\n"
                        rb"(?:(?!Anonymous:)[^\n]*\n)*Anonymous: +(\d+)", re.M)
# A whole reading (every field) holds the interpreter lock 0.3-0.9 ms on
# an H100 host (mallinfo2 ~0.1 ms, torch's memory_reserved ~0.13 ms)
# and, where /proc/self/status lists no RssFile, reads /proc/self/smaps
# (5-35 ms with a CUDA process's ~500 mappings). So every GAUGE_PERIOD_S
# the gauge's thread reads the resident set alone, and takes a whole
# reading when it has passed the last whole reading by WHOLE_STEP: a
# sample's highest whole reading lies within WHOLE_STEP of its highest
# resident set.
WHOLE_STEP = 0.005
_gauge = None          # the running gauge thread, or None
_reader = None         # its sources, while it runs
_gauge_users = 0       # samples running with it
_gauge_lock = threading.Lock()
_read_lock = threading.Lock()


class _MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def _smaps_split() -> tuple:
    """(file, anon) bytes resident, from /proc/self/smaps: file is the Rss
    of the mappings of files outside /dev (libraries, data files) less
    their pages copied on write, anon the rest (heap, stacks, anonymous
    and device mappings, where pinned host blocks lie), as status's
    RssFile and RssAnon + RssShmem count them."""
    fd = os.open("/proc/self/smaps", os.O_RDONLY)
    try:
        parts = []
        while True:
            got = os.read(fd, 1 << 22)
            if not got:
                break
            parts.append(got)
    finally:
        os.close(fd)
    file = anon = 0
    for path, rss, copied in _SMAPS_VMA.findall(b"".join(parts)):
        if path.startswith(b"/") and not path.startswith(b"/dev/"):
            file += int(rss) - int(copied)
            anon += int(copied)
        else:
            anon += int(rss)
    return file << 10, anon << 10


class _Reader:
    """The gauge's sources while it runs. Its two /proc files stay open
    and are read again from offset 0, by pread and mallinfo2 called
    through ctypes without letting go of the interpreter lock (each takes
    microseconds): a reading takes the lock once."""

    def __init__(self):
        libc = ctypes.PyDLL(None)
        self.pread = libc.pread
        self.pread.argtypes = [ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_size_t, ctypes.c_long]
        self.pread.restype = ctypes.c_ssize_t
        self.buf = ctypes.create_string_buffer(1 << 15)
        self.mallinfo2 = getattr(libc, "mallinfo2", None)
        if self.mallinfo2 is not None:
            self.mallinfo2.argtypes = []
            self.mallinfo2.restype = _MallInfo2
        self.statm = os.open("/proc/self/statm", os.O_RDONLY)
        self.status = os.open("/proc/self/status", os.O_RDONLY)
        self.split_in_status = b"RssFile:" in self._read(self.status)
        self.whole_rss = 0     # rss of the last whole reading

    def _read(self, fd: int) -> bytes:
        n = self.pread(fd, self.buf, len(self.buf), 0)
        if n < 0:
            raise OSError("pread of a /proc file failed")
        return self.buf.raw[:n]

    def close(self) -> None:
        os.close(self.statm)
        os.close(self.status)

    def rss(self) -> Gauge:
        """A reading of the resident set alone."""
        t = time.perf_counter_ns()
        rss = int(self._read(self.statm).split()[1]) * _PAGE
        return Gauge(t, rss, None, None, None, None, None, None)

    def whole(self, g: Gauge | None = None) -> Gauge:
        """A reading of every field (rss split from smaps where status has
        no split), from g, a reading of the resident set, where given."""
        g = self.rss() if g is None else g
        if self.split_in_status:
            kb = {"anon": 0, "file": 0}
            for key, n in _STATUS_RSS.findall(self._read(self.status)):
                kb[_STATUS_KEYS[key]] += int(n)
            file, anon = kb["file"] << 10, kb["anon"] << 10
        else:
            file, anon = _smaps_split()
        heap_used = heap_free = None
        if self.mallinfo2 is not None:
            mi = self.mallinfo2()
            heap_used, heap_free = mi.uordblks + mi.hblkhd, mi.fordblks
        # torch may be half imported by another thread: no CUDA context
        # exists before its cuda module is whole
        cuda = getattr(sys.modules.get("torch"), "cuda", None)
        pinned = reserved = 0
        if getattr(cuda, "is_initialized", None) and cuda.is_initialized():
            pinned = cuda.host_memory_stats().get("allocated_bytes.current",
                                                  0)
            reserved = cuda.memory_reserved()
        self.whole_rss = g.rss
        return g._replace(file=file, anon=anon, heap_used=heap_used,
                          heap_free=heap_free, pinned=pinned,
                          device_reserved=reserved)

    def tick(self) -> Gauge:
        """The gauge thread's reading: the resident set, and a whole
        reading where it passed the last by WHOLE_STEP."""
        g = self.rss()
        if g.rss <= self.whole_rss * (1 + WHOLE_STEP):
            return g
        return self.whole(g)


def _keep(tick: bool) -> None:
    """Keep the thread's reading (`tick`) or a whole one. One reading at a
    time, so that they are kept in time order."""
    with _read_lock:
        if _reader is not None:
            _GAUGES.append(_reader.tick() if tick else _reader.whole())


class _GaugeThread(threading.Thread):
    def __init__(self):
        super().__init__(name="gencore-mem", daemon=True)
        self.halt = threading.Event()

    def run(self):
        while not self.halt.wait(GAUGE_PERIOD_S):
            _keep(tick=True)


def _gauge_on() -> None:
    """A whole reading; the first running sample starts the thread."""
    global _gauge, _reader, _gauge_users
    with _gauge_lock:
        _gauge_users += 1
        if _reader is None:
            _reader = _Reader()
        _keep(tick=False)
        if _gauge is None:
            _gauge = _GaugeThread()
            _gauge.start()


def _gauge_off() -> None:
    """A whole reading; the last running sample stops the thread first."""
    global _gauge, _reader, _gauge_users
    with _gauge_lock:
        _gauge_users -= 1
        if _gauge_users == 0:
            _gauge.halt.set()
            _gauge.join()
            _gauge = None
        _keep(tick=False)
        if _gauge_users == 0:
            with _read_lock:
                _reader.close()
                _reader = None


_MB = 1_000_000   # the MB of the [mem] line and spans.json
_FIELDS = ("file", "anon", "heap_used", "heap_free", "pinned",
           "device_reserved")


class Peak:
    """One sample's whole reading of the highest resident set (`gauge`,
    by `highest`), its time from the sample's start (`at_s`), and the
    innermost span open on each thread then (`open`, {thread: span
    name}); filled when the sample ends."""

    __slots__ = ("gauge", "at_s", "open")

    def __init__(self):
        self.gauge, self.at_s, self.open = None, 0.0, {}

    def fill(self, sample_id: int, t0: int, lo: int, hi: int) -> None:
        """From the readings taken from lo to hi; t0: the sample's start."""
        mine = [g for g in gauges() if lo <= g.t_ns <= hi]
        if not mine:
            return
        g = self.gauge = highest(mine)
        self.at_s = (g.t_ns - t0) / 1e9
        self.open = open_at([s for s in spans() if s.sample == sample_id],
                            g.t_ns)

    def line(self) -> str | None:
        """The `[mem]` line of the --debug output."""
        g = self.gauge
        if g is None:
            return None
        parts = ", ".join(f"{k} {getattr(g, k) / _MB:.1f}" for k in _FIELDS
                          if getattr(g, k) is not None)
        spans_ = ", ".join(f"{t} {n}" for t, n in sorted(self.open.items()))
        return (f"[mem] peak rss {g.rss / _MB:.1f} MB at {self.at_s:.3f}s "
                f"({parts} MB); open: {spans_ or 'no span'}")


def highest(gauges_: list) -> Gauge:
    """The reading of the highest rss among the whole readings, where
    there are such readings."""
    whole = [g for g in gauges_ if g.file is not None]
    return max(whole or gauges_, key=lambda g: g.rss)


def open_at(spans_: list, t_ns: int) -> dict:
    """{thread: name of its innermost span open at t_ns} (nested spans:
    the innermost is the shortest)."""
    best = {}
    for s in spans_:
        if s.t0_ns <= t_ns <= s.t1_ns:
            b = best.get(s.thread)
            if b is None or s.t1_ns - s.t0_ns < b.t1_ns - b.t0_ns:
                best[s.thread] = s
    return {t: s.name for t, s in best.items()}


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


def gauge_events(gauges_: list, t_clock_ns: int, clock_ts_us: float,
                 pid: int) -> list:
    """Chrome-trace counter ("C") events of gauge readings, on the clock
    of `chrome_events`: one `host memory MB` event a reading (a series a
    field held in host memory; a field that was not read is left out) and
    one `device reserved MB` a whole reading."""
    out = []
    for g in gauges_:
        ts = clock_ts_us + (g.t_ns - t_clock_ns) / 1e3
        host = {k: getattr(g, k) / _MB for k in ("rss",) + _FIELDS[:-1]
                if getattr(g, k) is not None}
        out.append({"ph": "C", "name": "host memory MB", "pid": pid,
                    "ts": ts, "args": host})
        if g.device_reserved is not None:
            out.append({"ph": "C", "name": "device reserved MB", "pid": pid,
                        "ts": ts, "args": {"device_reserved":
                                           g.device_reserved / _MB}})
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
    events += gauge_events([g for g in gauges() if g.t_ns >= t_start],
                           t_clock, zero + t_clock / 1e3, os.getpid())
    events.append({"ph": "i", "s": "p", "name": "gencore.clock",
                   "pid": os.getpid(), "tid": 0, "ts": zero + t_clock / 1e3})
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump({"traceEvents": events,
                   "clock": {"perf_counter_ns": t_clock,
                             "ts_us": zero + t_clock / 1e3}}, f)
