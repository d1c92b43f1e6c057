"""What watches the process during the window: threads that read its
resident memory (every 10 ms from /proc/self/statm) and, in the traced
run, what each thread of the program is doing (every few ms from
sys._current_frames); and, around each sample, the process's CPU and
garbage-collector seconds (HostClock)."""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from collections import Counter

PAGE = os.sysconf("SC_PAGE_SIZE")


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


class _Loop(threading.Thread):
    def __init__(self, period_s: float):
        super().__init__(daemon=True)
        self.period = period_s
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            self.tick()
            self._halt.wait(self.period)

    def stop(self):
        self._halt.set()
        self.join(timeout=5)
        if self.is_alive():
            raise RuntimeError(f"{type(self).__name__} did not stop")

    def tick(self):
        raise NotImplementedError


class RssPeak(_Loop):
    """The highest resident set size read while it runs."""

    def __init__(self, period_s: float = 0.01):
        super().__init__(period_s)
        self.peak = rss_bytes()

    def tick(self):
        self.peak = max(self.peak, rss_bytes())

    def stop(self):
        super().stop()
        self.tick()


class Stacks(_Loop):
    """For each sample time, the innermost frame of the program's package
    on each of its threads, marked `wait:` where the thread itself sits in
    a lock or queue wait."""

    def __init__(self, package: str, period_s: float = 0.005):
        super().__init__(period_s)
        self.mark = os.sep + package + os.sep
        self.samples = []      # (perf_counter, [label, ...])

    def tick(self):
        t = time.perf_counter()
        me = threading.get_ident()
        labels = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            waiting = frame.f_code.co_filename.endswith(("threading.py", "queue.py"))
            f = frame
            while f is not None and self.mark not in f.f_code.co_filename:
                f = f.f_back
            if f is None:
                continue
            name = f.f_code.co_filename.split(self.mark, 1)[1]
            labels.append(("wait:" if waiting else "") +
                          f"{name}:{f.f_code.co_name}")
        self.samples.append((t, labels))

    def label(self, t0: float, t1: float) -> str:
        """What the program's threads did most between t0 and t1: the
        commonest label of a working thread, else of a waiting one."""
        work, wait = Counter(), Counter()
        for t, labels in self.samples:
            if t0 <= t <= t1:
                for lb in labels:
                    (wait if lb.startswith("wait:") else work)[lb] += 1
        for c in (work, wait):
            if c:
                lb, n = c.most_common(1)[0]
                return f"{lb} ({n}/{sum(c.values())})"
        return "no program frame"


class HostClock:
    """Readings around each sample that tell whether a slow one did more
    work or ran on a slower machine: this process's CPU seconds (all its
    threads; `sys_s` of them in the kernel) and its seconds in the garbage
    collector. (The machine's other load is not read: where the benchmark
    runs, /proc/stat and the page-fault and context-switch counts of
    getrusage do not move.)"""

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t0 = 0.0

    def _gc(self, phase, _info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t0

    def __enter__(self):
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)

    def read(self) -> dict:
        t = os.times()
        return {"wall": time.perf_counter(), "cpu": t.user + t.system,
                "sys": t.system, "gc": self.gc_s}

    @staticmethod
    def delta(a: dict, b: dict) -> dict:
        return {"wall_s": b["wall"] - a["wall"], "cpu_s": b["cpu"] - a["cpu"],
                "sys_s": b["sys"] - a["sys"], "gc_s": b["gc"] - a["gc"]}


def host_line(d: dict) -> str:
    return " ".join(f"{k} {v:.3f}" for k, v in d.items())
