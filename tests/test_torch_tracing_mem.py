"""The recorder's memory gauge (`gencore_tpu_torch/utils/tracing.py`) over
CLI runs on the CPU: no thread and no reading with recording off; under
--debug, readings on the spans' clock through the run, one whole reading
just before its root span and one just after, whose fields add up to the
resident set; the `[mem]` line; and GENCORE_TRACE_DIR's counter events."""

import ctypes
import json
import re
import threading
import time

import pytest

from gencore_tpu_torch import cli
from gencore_tpu_torch.io import fasta
from gencore_tpu_torch.tools import workloads
from gencore_tpu_torch.utils import tracing

FIELDS = ("t_ns", "rss", "file", "anon", "heap_used", "heap_free", "pinned",
          "device_reserved")
HEAP = hasattr(ctypes.CDLL(None), "mallinfo2")


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    bam, fa, _n = workloads.small_panel(str(tmp_path_factory.mktemp("panel")))
    return bam, fa


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    return workloads.deep_panel(str(tmp_path_factory.mktemp("deep")),
                                n_fragments=3000)


@pytest.fixture(autouse=True)
def clean_recorder():
    tracing.disable()
    tracing.take()
    tracing.take("gauges")
    yield
    tracing.disable()
    tracing.take()
    tracing.take("gauges")


def _cli(inputs, tmp_path, extra, capfd=None):
    bam, fa = inputs
    rc = cli.main(["-i", bam, "-o", str(tmp_path / "o.bam"), "-r", fa,
                   "-j", str(tmp_path / "o.json"),
                   "-h", str(tmp_path / "o.html"), "--device", "cpu",
                   "--stream", "--windows", "3", *extra])
    assert rc == 0
    return capfd.readouterr().err if capfd is not None else None


def _root(spans):
    (root,) = [s for s in spans if s.name == "cli.sample"]
    return root


def test_off_starts_no_gauge_thread_and_reads_nothing(panel, tmp_path,
                                                      monkeypatch):
    started, reads = [], []
    orig_start = tracing._GaugeThread.start
    orig_keep = tracing._keep

    def start(self):
        started.append(self.name)
        orig_start(self)

    def keep(tick):
        reads.append(tick)
        return orig_keep(tick)

    monkeypatch.setattr(tracing._GaugeThread, "start", start)
    monkeypatch.setattr(tracing, "_keep", keep)
    _cli(panel, tmp_path, [])
    assert started == [] and reads == []
    assert tracing.gauges() == []
    assert "gencore-mem" not in {t.name for t in threading.enumerate()}
    # the same run under --debug starts it, once, and stops it
    _cli(panel, tmp_path, ["--debug"])
    assert started == ["gencore-mem"] and reads
    assert "gencore-mem" not in {t.name for t in threading.enumerate()}
    assert tracing._gauge is None and tracing._gauge_users == 0
    assert tracing._reader is None


def _by_thread(monkeypatch):
    """[(thread name, reading)] of every whole reading, as taken."""
    taken = []
    read = tracing._Reader.whole

    def whole(self, g=None):
        g = read(self, g)
        taken.append((threading.current_thread().name, g))
        return g

    monkeypatch.setattr(tracing._Reader, "whole", whole)
    return taken


def test_readings_lie_inside_the_run_on_the_spans_clock(panel, tmp_path,
                                                        monkeypatch):
    taken = _by_thread(monkeypatch)
    _cli(panel, tmp_path, ["--debug"])
    spans, gs = tracing.take(), tracing.take("gauges")
    root = _root(spans)
    assert len(gs) >= 3
    assert [g.t_ns for g in gs] == sorted(g.t_ns for g in gs)
    # the sample reads once before its root span opens and once after it
    # closes; every other reading is the thread's, inside the span
    assert gs[0].t_ns < root.t0_ns and gs[-1].t_ns > root.t1_ns
    assert all(root.t0_ns <= g.t_ns <= root.t1_ns for g in gs[1:-1])
    mine = [g for t, g in taken if t != "gencore-mem"]
    assert mine == [gs[0], gs[-1]]
    whole = [g for g in gs if g.pinned is not None]
    assert whole and all(g.rss > 0 for g in gs)
    for g in gs:
        assert g._fields == FIELDS and isinstance(g.rss, int)
        if g.pinned is None:          # the resident set alone
            assert set(g[2:]) == {None}
            continue
        for f in FIELDS:
            v = getattr(g, f)
            if f.startswith("heap_") and not HEAP:
                assert v is None
            else:
                assert isinstance(v, int) and v >= 0, (f, v)
        assert g.file > 0 and g.anon > 0


def test_thread_takes_whole_readings_as_the_resident_set_climbs(
        panel, tmp_path, monkeypatch):
    """Every GAUGE_PERIOD_S the thread reads the resident set; it takes a
    whole reading only where that passed the last whole one by
    WHOLE_STEP."""
    _cli(panel, tmp_path, ["--debug"])
    gs = tracing.gauges()
    assert gs[0].pinned is not None and gs[-1].pinned is not None
    top = gs[0].rss
    for g in gs[1:-1]:
        assert (g.pinned is not None) == (g.rss > top * (1 + tracing.WHOLE_STEP))
        if g.pinned is not None:
            top = g.rss
    assert tracing.highest(gs).rss >= max(g.rss for g in gs) / (
        1 + tracing.WHOLE_STEP) - 1
    # the rule on a scripted resident set
    r = tracing._Reader()
    try:
        script = iter([100_000, 100_400, 100_600, 100_600, 99_000, 101_200])
        real = r.rss
        monkeypatch.setattr(r, "rss", lambda: real()._replace(rss=next(script)))
        took = [r.whole().rss] + [r.tick() for _ in range(5)]
    finally:
        r.close()
    assert took[0] == 100_000
    assert [g.rss for g in took[1:]] == [100_400, 100_600, 100_600, 99_000,
                                         101_200]
    assert [g.pinned is not None for g in took[1:]] == [False, True, False,
                                                        False, True]


def test_pinned_and_device_fields_are_zero_on_the_cpu(panel, tmp_path):
    _cli(panel, tmp_path, ["--debug"])
    gs = [g for g in tracing.gauges() if g.pinned is not None]
    assert gs and all(g.pinned == 0 and g.device_reserved == 0 for g in gs)


def _five(g):
    """The benchmark's five holders at reading g (harness/memory.py)."""
    other = max(0, g.anon - g.heap_used - g.heap_free - g.pinned)
    return g.file + g.pinned + g.heap_used + g.heap_free + other


def test_holders_add_up_to_the_resident_set_on_the_deep_panel(deep,
                                                              tmp_path):
    if not HEAP:
        pytest.skip("this C library has no mallinfo2")
    _cli(deep, tmp_path, ["--debug"])
    peak = tracing.highest(tracing.gauges())
    assert abs(peak.file + peak.anon - peak.rss) <= 0.02 * peak.rss
    assert abs(_five(peak) - peak.rss) <= 0.02 * peak.rss
    assert peak.heap_used > 0 and peak.heap_free >= 0


def test_take_empties_the_readings(panel, tmp_path):
    _cli(panel, tmp_path, ["--debug"])
    kept = tracing.gauges()
    assert kept and tracing.gauges() == kept     # read, left in place
    assert tracing.take("gauges") == kept
    assert tracing.gauges() == [] and tracing.take("gauges") == []
    assert tracing.spans()                        # spans are taken apart
    with pytest.raises(KeyError):
        tracing.take("nothing")


def test_trace_dir_writes_counter_events(panel, tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("GENCORE_TRACE_DIR", str(trace_dir))
    _cli(panel, tmp_path, [])
    with open(trace_dir / "spans.json") as f:
        events = json.load(f)["traceEvents"]
    (root,) = [e for e in events if e["ph"] == "X" and e["name"] == "cli.sample"]
    host = [e for e in events if e["ph"] == "C"
            and e["name"] == "host memory MB"]
    dev = [e for e in events if e["ph"] == "C"
           and e["name"] == "device reserved MB"]
    gs = tracing.gauges()
    assert len(host) == len(gs) >= 3
    assert len(dev) == len([g for g in gs if g.pinned is not None]) >= 2
    end = root["ts"] + root["dur"]
    assert host[0]["ts"] <= root["ts"] and host[-1]["ts"] >= end
    for e in host:
        if e is not host[0] and e is not host[-1]:
            assert root["ts"] <= e["ts"] <= end + 1
        assert e["args"]["rss"] > 0
        assert set(e["args"]) in ({"rss"}, {"rss", "file", "anon", "heap_used",
                                            "heap_free", "pinned"})
        assert e["args"].get("pinned", 0) == 0
    assert all(e["args"] == {"device_reserved": 0.0} for e in dev)


def _hold_in_fasta_load(monkeypatch, nbytes=256 << 20):
    """Make the reference load hold nbytes resident for a while, so that
    the run's highest resident set falls inside the span fasta.load."""
    load = fasta.FastaRef.load

    def held(*a, **k):
        buf = bytearray(nbytes)
        buf[::4096] = b"\1" * len(range(0, nbytes, 4096))
        time.sleep(10 * tracing.GAUGE_PERIOD_S)
        del buf
        return load(*a, **k)

    monkeypatch.setattr(fasta.FastaRef, "load", staticmethod(held))


def test_mem_line_names_a_span_open_at_the_peak(panel, tmp_path, capfd,
                                                monkeypatch):
    _hold_in_fasta_load(monkeypatch)
    err = _cli(panel, tmp_path, ["--debug"], capfd)
    (line,) = [ln for ln in err.splitlines() if ln.startswith("[mem] ")]
    m = re.match(r"\[mem\] peak rss ([0-9.]+) MB at ([0-9.]+)s \((.*) MB\); "
                 r"open: (.*)$", line)
    assert m, line
    spans, gs = tracing.spans(), tracing.gauges()
    peak = tracing.highest(gs)
    assert float(m.group(1)) == pytest.approx(peak.rss / 1e6, abs=0.06)
    assert "file " in m.group(3) and "pinned 0.0" in m.group(3)
    named = dict(part.rsplit(" ", 1) for part in m.group(4).split(", "))
    assert named["MainThread"] == "fasta.load"
    for thread, name in named.items():
        assert any(s.thread == thread and s.name == name
                   and s.t0_ns <= peak.t_ns <= s.t1_ns for s in spans)
    # no line without --debug
    err = _cli(panel, tmp_path, [], capfd)
    assert "[mem]" not in err


def test_open_at_takes_each_threads_innermost_span():
    Span = tracing.Span
    sp = [Span(1, 0, 1, -1, "MainThread", "cli.sample", 0, 100, 0, None),
          Span(2, 1, 1, -1, "MainThread", "stream.windows", 10, 90, 0, None),
          Span(3, 2, 1, 0, "gencore-collect", "collect", 20, 40, 0, None),
          Span(4, 3, 1, 0, "gencore-collect", "assemble", 25, 35, 0, None),
          Span(5, 2, 1, 1, "gencore-collect", "collect", 50, 60, 0, None)]
    assert tracing.open_at(sp, 30) == {"MainThread": "stream.windows",
                                       "gencore-collect": "assemble"}
    assert tracing.open_at(sp, 45) == {"MainThread": "stream.windows"}
    assert tracing.open_at(sp, 200) == {}


def test_smaps_splits_where_status_does_not(panel, tmp_path, monkeypatch):
    """On a kernel whose status lists VmRSS alone, every whole reading
    splits rss into file and anon from smaps; the split adds up to the
    resident set as it was around the parse."""
    init = tracing._Reader.__init__
    split_ = tracing._smaps_split
    after = {}

    def no_split_in_status(self):
        init(self)
        self.split_in_status = False

    def smaps_split():
        file, anon = split_()
        after[(file, anon)] = _statm_bytes()
        return file, anon

    monkeypatch.setattr(tracing._Reader, "__init__", no_split_in_status)
    monkeypatch.setattr(tracing, "_smaps_split", smaps_split)
    _cli(panel, tmp_path, ["--debug"])
    gs = tracing.gauges()
    split = [g for g in gs if g.file is not None]
    assert len(split) >= 2 and len(split) == len(after)
    assert all((g.pinned is None) == (g.file is None) for g in gs)
    for a, b in zip(split[:-1], split[1:-1]):
        assert b.rss > a.rss * (1 + tracing.WHOLE_STEP)
    for g in split:
        lo, hi = sorted((g.rss, after[(g.file, g.anon)]))
        assert 0.98 * lo <= g.file + g.anon <= 1.02 * hi
    top = tracing.highest(gs)
    assert top.rss >= max(g.rss for g in gs) / (1 + tracing.WHOLE_STEP) - 1


def _statm_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * tracing._PAGE


def test_smaps_split_agrees_with_status():
    r = tracing._Reader()
    try:
        if not r.split_in_status:
            pytest.skip("this kernel's status has no RssFile")
        g = r.whole()
        file, anon = tracing._smaps_split()
    finally:
        r.close()
    assert abs(file + anon - g.rss) <= 0.02 * g.rss
    assert abs(file - g.file) <= 0.02 * g.file
