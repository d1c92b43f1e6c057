"""The readers of the program's spans: the five span metrics over a
synthetic window's spans, nothing where the program recorded none, and
the device's idle gaps named by the spans open over them through
`trace.Window.offset`."""

import json
from collections import namedtuple

import pytest

from harness import cells, spans
from harness import trace as tr

Span = namedtuple("Span", "id parent sample window thread name t0_ns t1_ns "
                          "cpu_ns attrs")
NEW = ("io.fasta_ms_per_Mread", "out.deflate_ms_per_Mread",
       "stream.dispatch_wait_pct", "stream.collect_wait_pct",
       "host.offcpu_pct")
S = 1_000_000_000   # ns a second


def _span(i, name, t0_s, t1_s, thread="MainThread", cpu_s=None, parent=0):
    cpu = t1_s - t0_s if cpu_s is None else cpu_s
    return Span(i, parent, 1, -1, thread, name, int(t0_s * S), int(t1_s * S),
                int(cpu * S), None)


def _sample(base):
    """One synthetic sample's spans from host second `base`: 4 s of
    reference load, 10 s of pass 2 in which the dispatch thread waits
    1 s and the collector 3 s, 0.5 s of deflate, and host stages of 6 s
    wall and 4.5 s CPU."""
    b = base
    return [
        _span(1, "cli.sample", b, b + 16),
        _span(2, "fasta.load", b, b + 3.5),
        _span(3, "genome.build", b + 4, b + 4.25),
        _span(4, "genome.upload", b + 4.25, b + 4.5),
        _span(5, "stream.windows", b + 5, b + 15),
        _span(6, "dispatch.wait", b + 5, b + 5.75),
        _span(7, "dispatch.backpressure", b + 14.75, b + 15),
        _span(8, "collect.wait", b + 5, b + 8, thread="gencore-collect"),
        _span(9, "write.deflate", b + 9, b + 9.5, thread="gencore-collect"),
        _span(10, "grouping", b + 6, b + 10, cpu_s=3.0),
        _span(11, "assemble", b + 10, b + 12, thread="gencore-collect",
              cpu_s=1.5),
        _span(12, "vote.device", b + 12, b + 13, cpu_s=0.0),  # not a leaf read
    ]


class Ctx:
    reads = 2_000_000
    window = None

    def __init__(self, sp):
        self.spans = sp


@pytest.fixture(scope="module")
def readers():
    from conftest import BENCH, ROOT
    spec = cells.load_spec(ROOT)
    return {m["name"]: (m, cells.load_metric(BENCH, m["name"]))
            for m in spec["per_layer"] if m["name"] in NEW}


def test_the_five_span_metrics_are_declared_and_found_by_name(readers):
    assert set(readers) == set(NEW)
    for name, (m, mod) in readers.items():
        assert (mod.SOURCE, mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["source"], m["unit"], m["layer"], m["moves"])
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"] == ["cfdna_duplex.families"]


def test_span_metrics_read_a_window_of_two_samples(readers):
    ctx = Ctx(_sample(100.0) + _sample(200.0))
    got = {n: mod.read(ctx) for n, (_m, mod) in readers.items()}
    # 2 x 4 s over 2M reads; 2 x 0.5 s
    assert got["io.fasta_ms_per_Mread"] == pytest.approx(4000.0)
    assert got["out.deflate_ms_per_Mread"] == pytest.approx(500.0)
    assert got["stream.dispatch_wait_pct"] == pytest.approx(10.0)
    assert got["stream.collect_wait_pct"] == pytest.approx(30.0)
    assert got["host.offcpu_pct"] == pytest.approx(25.0)


def test_span_metrics_read_nothing_without_spans(readers):
    class NoSpans:
        reads = 2_000_000
        spans = None
        window = None
    for _m, mod in readers.values():
        assert mod.read(NoSpans()) is None
        assert mod.read(Ctx([_span(1, "cli.sample", 0, 1)])) is None


def test_program_spans_are_those_of_the_window(monkeypatch):
    import sys
    import types

    rec = types.SimpleNamespace(spans=lambda: [_span(1, "fasta.load", 5, 6),
                                               _span(2, "fasta.load", 11, 12)])
    monkeypatch.setitem(sys.modules, spans.RECORDER, rec)

    class W:
        host_t0 = 10.0

    class FromProgram:
        reads = 1_000_000
        window = W()
    assert [s.id for s in spans.of(FromProgram())] == [2]
    assert spans.ms_per_mread(FromProgram(), ["fasta.load"]) == pytest.approx(1000.0)
    # a program without the recorder: nothing
    monkeypatch.setitem(sys.modules, spans.RECORDER, types.SimpleNamespace())
    assert spans.of(FromProgram()) is None


def test_idle_gaps_are_named_by_the_spans_open_over_them(tmp_path):
    # host clock: marker at 100.0 s, trace clock at 5,000,000 us; the
    # device idles from 100.2 s to 103.0 s, from 103.1 s to 104.0 s and
    # from the first marker's end to 100.1 s
    ev = [("kernel", "void at::cuda::spin_kernel(long)", 5_000_000, 1),
          ("kernel", "void upload_score_kernel(Params)", 5_100_000, 100_000),
          ("kernel", "void vote_window_kernel(Args)", 8_000_000, 100_000),
          ("kernel", "void at::cuda::spin_kernel(long)", 9_000_000, 1)]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": [
        {"cat": c, "name": n, "ts": ts, "dur": d} for c, n, ts, d in ev]}))
    w = tr.Window(str(p), 100.0)
    sp = [_span(1, "cli.sample", 99.0, 105.0),
          _span(2, "fasta.load", 100.1, 102.9, parent=1),
          _span(3, "stream.windows", 102.9, 104.5, parent=1),
          _span(4, "collect.wait", 100.0, 103.05, thread="gencore-collect"),
          _span(5, "assemble", 103.1, 104.0, thread="gencore-collect")]
    gaps = spans.idle_spans(w, sp)
    assert [g[1] for g in gaps] == pytest.approx([2.8, 0.9, 0.099999])
    assert gaps[0][0] == ("gencore-collect:collect.wait | main:fasta.load "
                          "@0.200s")
    assert gaps[1][0] == ("gencore-collect:assemble | main:stream.windows "
                          "@3.100s")
    assert gaps[2][0] == ("gencore-collect:collect.wait | "
                          "main:cli.sample @0.000s")
    # the root holds the gap; its child that fills most of it follows
    sp.append(_span(6, "index", 100.0, 100.04, parent=1))
    assert spans.open_over(sp, 100.0, 100.1) == (
        "gencore-collect:collect.wait | main:cli.sample>index 0.040s")
    assert spans.open_over([], 1.0, 2.0) == "no span"
