"""Reading the device trace of the window: the operations that ran on the
device, the union of their intervals (device busy), the idle gaps between
them labelled by what the host was doing, and kernel time by name.

The window is bracketed by two marker kernels (`torch.cuda._sleep`,
named spin_kernel) launched on an idle device at known host times: they
tie the trace's clock to the host's and are left out of every sum.
"""

from __future__ import annotations

import json
import re
from collections import Counter

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def kernel_base(name: str) -> str:
    """The function name of a kernel's demangled name: `void
    (anonymous namespace)::foo<true>(Args)` -> `foo`."""
    s = name.replace("(anonymous namespace)", "anonymous")
    while "<" in s and re.search(r"<[^<>]*>", s):
        s = re.sub(r"<[^<>]*>", "", s)
    head = s.split("(", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def device_events(trace_path: str) -> list:
    """[(cat, name, start_us, end_us)] of the trace's device operations,
    in start order."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "ts" in e and "dur" in e:
            ts = float(e["ts"])
            out.append((e["cat"], e.get("name", ""), ts, ts + float(e["dur"])))
    out.sort(key=lambda x: x[2])
    return out


def union(iv: list) -> list:
    """Merged [(start, end)] of intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy(iv: list) -> float:
    return sum(b - a for a, b in union(iv))


def idle_pct(busy_s: float, window_s: float):
    """100 x the share of the window no device operation covered."""
    if window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)


def gaps(iv: list, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] not covered by iv, longest first."""
    out, at = [], lo
    for a, b in union(iv):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


class Window:
    """The traced window's device operations between the two markers, with
    host times (seconds on the host's perf_counter clock)."""

    def __init__(self, trace_path: str, host_t0: float):
        ev = device_events(trace_path)
        marks = [e for e in ev if e[0] == "kernel" and MARKER in e[1]]
        if len(marks) < 2:
            raise ValueError("the trace lost a window marker")
        self.offset = marks[0][2] / 1e6 - host_t0
        lo, hi = marks[0][3], marks[-1][2]
        self.ops = [e for e in ev if e[2] >= lo and e[3] <= hi
                    and MARKER not in e[1]]
        self.host_t0 = host_t0
        self.lo_us, self.hi_us = lo, hi

    def kernels(self) -> list:
        return [e for e in self.ops if e[0] == "kernel"]

    def busy_s(self) -> float:
        return busy([(a, b) for _, _, a, b in self.ops]) / 1e6

    def kernel_s(self, names) -> float:
        """Summed duration of the kernels whose function name is in names."""
        names = set(names)
        return sum(b - a for c, n, a, b in self.ops
                   if c == "kernel" and kernel_base(n) in names) / 1e6

    def by_name(self) -> list:
        """[(name, seconds)] of the device operations, most time first."""
        t = Counter()
        for c, n, a, b in self.ops:
            t[kernel_base(n) if c == "kernel" else n] += (b - a) / 1e6
        return t.most_common()

    def idle_gaps(self, label=None, top: int = 10) -> list:
        """The longest idle gaps of the window, each named by what the host
        was doing in it (label(host_t0, host_t1) -> str)."""
        out = []
        iv = [(a, b) for _, _, a, b in self.ops]
        for a, b in gaps(iv, self.lo_us, self.hi_us)[:top]:
            h0, h1 = a / 1e6 - self.offset, b / 1e6 - self.offset
            what = label(h0, h1) if label else "host"
            out.append([f"{what} @{h0 - self.host_t0:.3f}s", (b - a) / 1e6])
        return out
