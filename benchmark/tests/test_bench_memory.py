"""The readers of the program's memory gauge: the five memory metrics at
the window's reading of highest resident set, nothing where the program
took no reading in the window, and the five adding up to that reading's
resident set; and a `--trace 0` run, which starts no gauge."""

from collections import namedtuple

import pytest

from harness import cells, memory

Gauge = namedtuple("Gauge", "t_ns rss file anon heap_used heap_free pinned "
                            "device_reserved")
NEW = {"mem.file_MB": "file", "mem.pinned_MB": "pinned",
       "mem.heap_used_MB": "heap_used", "mem.heap_free_MB": "heap_free",
       "mem.other_MB": "other"}
S = 1_000_000_000   # ns a second
M = 1_000_000       # bytes an MB


def _g(t_s, rss, *fields):
    """A whole reading: file, anon, heap_used, heap_free, pinned (MB, or
    None where not read)."""
    return Gauge(int(t_s * S), rss * M,
                 *(None if v is None else v * M for v in fields), 7 * M)


class W:
    host_t0 = 100.0


class Ctx:
    window = W()

    def __init__(self, gs):
        self.gauges = gs


@pytest.fixture(scope="module")
def readers():
    from conftest import BENCH, ROOT
    spec = cells.load_spec(ROOT)
    return {m["name"]: (m, cells.load_metric(BENCH, m["name"]))
            for m in spec["per_layer"] if m["name"] in NEW}


def test_the_five_memory_metrics_are_declared_and_found_by_name(readers):
    assert set(readers) == set(NEW)
    for name, (m, mod) in readers.items():
        assert (mod.SOURCE, mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["source"], m["unit"], m["layer"], m["moves"])
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert m["moves"] == "host_peak_rss_MB"
        assert m["workloads"] == ["cfdna_duplex.families"]


def _rss(t_s, rss):
    """A reading of the resident set alone."""
    return Gauge(int(t_s * S), rss * M, None, None, None, None, None, None)


WINDOW = [_g(101, 5000, 800, 4200, 600, 1500, 300),
          _rss(101.5, 5910),               # above the peak, but not whole
          _g(102, 5900, 900, 5000, 700, 2100, 200),   # the peak
          _g(102.5, 5950, None, None, 720, 2100, 200),  # no split of rss
          _g(103, 5500, 900, 4600, 650, 2000, 200)]


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_takes_the_reading_of_highest_rss(readers, name):
    want = {"file": 900, "pinned": 200, "heap_used": 700,
            "heap_free": 2100, "other": 5000 - 700 - 2100 - 200}
    mod = readers[name][1]
    assert mod.read(Ctx(WINDOW)) == pytest.approx(want[NEW[name]])
    # the order of the readings does not matter
    assert mod.read(Ctx(WINDOW[::-1])) == pytest.approx(want[NEW[name]])


def test_the_five_add_up_to_the_peak_rss_less_what_falls_outside(readers):
    got = {n: mod.read(Ctx(WINDOW)) for n, (_m, mod) in readers.items()}
    assert sum(got.values()) == pytest.approx(5900)
    # glibc's free heap larger than the anonymous memory left: `other` is
    # 0, and the five exceed the peak by what falls outside it
    over = [_g(101, 3000, 500, 2500, 900, 1800, 100)]
    got = {n: mod.read(Ctx(over)) for n, (_m, mod) in readers.items()}
    assert got["mem.other_MB"] == 0
    assert sum(got.values()) - 3000 == pytest.approx(900 + 1800 + 100 - 2500)


def test_no_reading_in_the_window_gives_nothing(readers, monkeypatch):
    import sys
    import types
    for _m, mod in readers.values():
        assert mod.read(Ctx([])) is None

    class FromProgram:
        window = W()
    # readings before the window's first marker are not the window's
    rec = types.SimpleNamespace(gauges=lambda: [_g(99, 9000, 1, 1, 1, 1, 0)])
    monkeypatch.setitem(sys.modules, memory.RECORDER, rec)
    for _m, mod in readers.values():
        assert mod.read(FromProgram()) is None
    # a program without the gauge (the parent of this recorder)
    monkeypatch.setitem(sys.modules, memory.RECORDER,
                        types.SimpleNamespace(spans=lambda: []))
    for _m, mod in readers.values():
        assert mod.read(FromProgram()) is None


def test_program_readings_are_those_of_the_window(monkeypatch):
    import sys
    import types
    rec = types.SimpleNamespace(gauges=lambda: [
        _g(99, 9000, 100, 8900, 10, 10, 0), *WINDOW])
    monkeypatch.setitem(sys.modules, memory.RECORDER, rec)

    class FromProgram:
        window = W()
    assert memory.peak(FromProgram()).rss == 5900 * M
    assert memory.at_peak_mb(FromProgram(), "file") == pytest.approx(900)


def test_without_heap_figures_the_heap_readers_give_nothing(readers):
    gs = [_g(101, 4000, 800, 3200, None, None, 300)]
    got = {n: mod.read(Ctx(gs)) for n, (_m, mod) in readers.items()}
    assert got["mem.heap_used_MB"] is None and got["mem.heap_free_MB"] is None
    assert got["mem.other_MB"] == pytest.approx(2900)
    assert got["mem.file_MB"] == pytest.approx(800)


def test_readings_of_the_resident_set_alone_give_nothing(readers):
    gs = [_rss(101, 4000), _g(102, 4100, None, None, 500, 600, 0)]
    for _m, mod in readers.values():
        assert mod.read(Ctx(gs)) is None


def test_untraced_run_starts_no_gauge(tmp_path, monkeypatch):
    import run
    import tiny
    from gencore_tpu_torch.utils import tracing
    monkeypatch.setenv("GENCORE_STREAM_THRESHOLD", "0")
    started = []
    monkeypatch.setattr(tracing._GaugeThread, "start",
                        lambda self: started.append(self.name))
    spec, bench = tiny.make(str(tmp_path))
    out = run.run_cell("cfdna_duplex.families", 2**31 + 3, 0.5, False,
                       device="cpu", spec=spec, workers=2, bench_dir=bench)
    assert out["correct"], out["checks"]
    assert started == [] and tracing.gauges() == []
