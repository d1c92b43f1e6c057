"""The port's one recorder (`gencore_tpu_torch/utils/tracing.py`): stage
totals, counters and spans over the streaming path and the in-memory
window pipeline of the CLI (`--device cpu`), recording off by default,
and GENCORE_TRACE_DIR's spans.json aligned with the profiler's trace."""

import json
import os
import re

import pytest

from gencore_tpu_torch import cli, engine
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.parallel.streaming import run_streaming
from gencore_tpu_torch.tools import workloads
from gencore_tpu_torch.utils import tracing

# the stage names the streaming path's --debug table had before spans
STREAM_STAGES = {"index", "sort", "sort.perm", "umi", "grouping",
                 "materialize", "materialize.host", "election", "score",
                 "score.dispatch", "vote", "vote.refbase", "vote.sync",
                 "assemble", "finalize"}
COUNTERS = {"wire.h2dMB", "wire.d2hMB", "out.records", "out.bytes_in",
            "out.bytes_out", "upload.dense_rows", "upload.sparse_rows",
            "upload.qual_raw_rows", "vote.window_jobs", "vote.gathered_jobs",
            "vote.gathered_members"}
MODES = {"stream": ["--stream", "--windows", "3"],
         "windows": ["--windows", "3"]}


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    bam, fa, _n = workloads.small_panel(str(tmp_path_factory.mktemp("panel")))
    return bam, fa


@pytest.fixture(autouse=True)
def clean_recorder():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _cli(panel, tmp_path, extra, capfd=None, monkeypatch=None, mode="stream"):
    if mode == "windows":
        monkeypatch.setenv("GENCORE_NO_STREAM", "1")
    bam, fa = panel
    rc = cli.main(["-i", bam, "-o", str(tmp_path / "o.bam"), "-r", fa,
                   "-j", str(tmp_path / "o.json"),
                   "-h", str(tmp_path / "o.html"), "--device", "cpu",
                   *MODES[mode], *extra])
    assert rc == 0
    return capfd.readouterr().err if capfd is not None else None


def _dur(s):
    return s.t1_ns - s.t0_ns


def test_off_records_no_span_and_makes_no_state(panel, tmp_path,
                                                monkeypatch):
    made = []

    class Counted(tracing._State):
        __slots__ = ()

        def __init__(self):
            made.append(1)
            super().__init__()

    monkeypatch.setattr(tracing, "_State", Counted)
    _cli(panel, tmp_path, [])
    assert not tracing.RECORDING
    assert tracing.spans() == [] and made == []


def test_spans_nest_share_the_sample_and_carry_windows(panel, tmp_path):
    _cli(panel, tmp_path, ["--debug"])
    assert not tracing.RECORDING        # on for the --debug run only
    spans = tracing.take()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["cli.sample"]
    assert {s.sample for s in spans} == {roots[0].sample}
    (windows,) = [s for s in spans if s.name == "stream.windows"]
    for s in spans:
        if s.parent == 0:
            continue
        p = by_id[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)
        # a span's parent is on its own thread, or a worker thread's
        # outermost spans hang under the pass-2 loop that started it
        assert p.thread == s.thread or p.id == windows.id, (s, p)
    threads = {s.thread for s in spans}
    assert {"gencore-decode", "gencore-collect"} <= threads
    for name in ("decode", "dispatch", "collect"):
        got = sorted(s.window for s in spans if s.name == name)
        assert got == [0, 1, 2], name
    names = {s.name for s in spans}
    assert {"fasta.load", "stream.header", "index", "stream.plan",
            "stream.tail", "report", "genome.build", "genome.upload",
            "decode.wait", "dispatch.wait", "dispatch.backpressure",
            "collect.wait", "payload", "write", "write.deflate"} <= names
    # every stage of a window's engine belongs to its window
    for s in spans:
        if s.name in STREAM_STAGES - {"index"}:
            assert s.window in (0, 1, 2), s
    assert all(s.cpu_ns >= 0 for s in spans)


def test_reference_load_spans_say_how_it_ran(panel, tmp_path):
    """Each CLI run loads its reference once (nothing is cached across
    runs), natively, builds no copy of the genome and sends it up in
    chunks; on the CPU device with no pinned staging."""
    for _ in range(2):
        _cli(panel, tmp_path, ["--debug"])
    spans = tracing.take()
    samples = [s.sample for s in spans if s.name == "cli.sample"]
    assert len(samples) == 2
    for sample in samples:
        mine = [s for s in spans if s.sample == sample]
        (load,) = [s for s in mine if s.name == "fasta.load"]
        (build,) = [s for s in mine if s.name == "genome.build"]
        (upload,) = [s for s in mine if s.name == "genome.upload"]
        assert load.attrs["native"] == 1 and load.attrs["contigs"] == 2
        assert load.attrs["bytes_read"] == 2 * os.path.getsize(panel[1])
        assert build.attrs == {"copied_MB": 0}
        assert upload.attrs["pinned"] == 0
        assert upload.attrs["chunks"] == -(-upload.attrs["bases"]
                                           // engine._GENOME_CHUNK) >= 1


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_stage_total_is_its_spans_sum(panel, tmp_path, capfd,
                                           monkeypatch, mode):
    err = _cli(panel, tmp_path, ["--debug"], capfd, monkeypatch, mode)
    spans = tracing.take()
    table = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\[stage\] (\S+): ([0-9.]+)s \(summed over windows\)$", err, re.M)}
    assert table
    for name, total in table.items():
        got = sum(_dur(s) for s in spans if s.name == name) / 1e9
        assert abs(got - total) <= 0.0005 + 1e-9, name
    assert "[pipeline]" not in err


def test_run_streaming_totals_equal_span_sums(panel, tmp_path):
    bam, fa = panel
    from gencore_tpu_torch.io.fasta import FastaRef
    opt = Options(input=bam, output=str(tmp_path / "o.bam"), ref_file=fa)
    totals, counts = {}, {}
    with tracing.recording():
        run_streaming(opt, bam, opt.output, fasta=FastaRef.load(fa),
                      n_windows=3, device="cpu", stage_totals=totals,
                      count_totals=counts)
    spans = tracing.take()
    assert set(totals) >= STREAM_STAGES | {"write", "payload",
                                           "write.deflate"}
    for name, total in totals.items():
        got = sum(_dur(s) for s in spans if s.name == name) / 1e9
        assert got == pytest.approx(total, rel=1e-9, abs=1e-12), name
    assert set(counts) == COUNTERS


def test_debug_tables_keep_every_stage_and_count_apart(panel, tmp_path,
                                                      capfd):
    err = _cli(panel, tmp_path, ["--debug"], capfd)
    stages = set(re.findall(r"^\[stage\] (\S+): [0-9.]+s \(summed over "
                            r"windows\)$", err, re.M))
    counts = dict(re.findall(r"^\[count\] (\S+): ([0-9.]+)$", err, re.M))
    assert STREAM_STAGES <= stages
    assert not {s for s in stages if s.startswith(("wire.", "out."))}
    assert set(counts) == COUNTERS
    assert int(counts["out.bytes_out"]) == (tmp_path / "o.bam").stat().st_size
    assert int(counts["out.records"]) > 0


def test_report_lines_count_no_bytes_or_records_as_seconds():
    t = tracing.StageTimer()
    with t.stage("a"):
        pass
    t.count("wire.h2dMB", 1234.5)
    t.count("out.records", 10_000)
    lines = t.report_lines()
    total = float(re.match(r"stage timings \(total ([0-9.]+)s\):",
                           lines[0]).group(1))
    assert total == pytest.approx(t.totals["a"], abs=0.0005)
    assert set(t.totals) == {"a"}
    assert "[count] out.records: 10000" in lines
    assert "[count] wire.h2dMB: 1234.500" in lines
    assert not any("wire" in ln and "%" in ln for ln in lines)


def test_trace_dir_writes_spans_aligned_with_the_profiler(panel, tmp_path,
                                                         monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("GENCORE_TRACE_DIR", str(trace_dir))
    _cli(panel, tmp_path, [])
    assert not tracing.RECORDING
    with open(trace_dir / "trace.json") as f:
        prof = json.load(f)["traceEvents"]
    with open(trace_dir / "spans.json") as f:
        doc = json.load(f)
    (clock,) = [e for e in prof if e.get("name") == "gencore.clock"]
    (tie,) = [e for e in doc["traceEvents"] if e["name"] == "gencore.clock"]
    # the clock readings made inside the profiler's event land inside it
    assert tie["ts"] == doc["clock"]["ts_us"]
    assert clock["ts"] <= tie["ts"] <= clock["ts"] + clock["dur"]
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    (root,) = [e for e in x if e["name"] == "cli.sample"]
    assert {"fasta.load", "stream.windows", "decode", "collect",
            "write.deflate", "report"} <= {e["name"] for e in x}
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M"}
    assert {"MainThread", "gencore-decode", "gencore-collect"} <= threads
    # the profiler's torch operations all ran inside the run's root span
    ops = [e for e in prof if e.get("cat") == "cpu_op"]
    assert ops
    assert min(e["ts"] for e in ops) >= root["ts"]
    assert max(e["ts"] + e["dur"] for e in ops) <= root["ts"] + root["dur"]
    # and the window vote's on the CPU (its plain twin) inside a dispatch
    # or collect span of the thread that ran it
    disp = [(e["ts"], e["ts"] + e["dur"]) for e in x
            if e["name"] in ("dispatch", "collect")]
    inside = [any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in disp)
              for e in ops if e["name"].startswith("aten::")]
    assert sum(inside) >= 0.95 * len(inside)


def test_clock_map_ties_perf_counter_to_the_profiler_clock():
    ev = {"name": "gencore.clock", "ts": 5_000.0, "dur": 40.0}
    # the profiler's clock: Unix microseconds since baseTimeNanoseconds
    trace = {"baseTimeNanoseconds": 1_000_000_000, "traceEvents": [ev]}
    zero = tracing.clock_map(trace, t_clock=2_000_000,
                             unix_clock=1_005_010_000)
    assert zero + 2_000_000 / 1e3 == pytest.approx(5_010.0)
    # without the base: tied at the event's start
    zero = tracing.clock_map({"traceEvents": [ev]}, 2_000_000, 0)
    assert zero + 2_000 == pytest.approx(5_000.0)
    assert tracing.clock_map({"traceEvents": []}, 1, 1) is None
