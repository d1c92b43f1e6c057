"""Interval union, idle gaps and idle share, and a window read from a
profiler trace between its two markers."""

import json

import pytest

from harness import trace as tr


def test_union_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert tr.union(iv) == [(0, 3), (5, 6), (8, 9)]
    assert tr.busy(iv) == 5
    assert tr.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert tr.idle_pct(5.0, 10.0) == 50.0
    assert tr.idle_pct(1.0, 0.0) is None


def test_kernel_base_names():
    assert tr.kernel_base("void vote_window_kernel(Args)") == "vote_window_kernel"
    assert tr.kernel_base("void (anonymous namespace)::score_map_kernel<true>"
                          "(unsigned char const*, Geometry)") == "score_map_kernel"
    assert tr.kernel_base("upload_score_kernel(Params)") == "upload_score_kernel"


def _trace(tmp_path, events):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": [
        {"cat": c, "name": n, "ts": ts, "dur": d} for c, n, ts, d in events]}))
    return str(p)


def test_window_between_markers(tmp_path):
    # host clock: marker at 100.0 s; trace clock at 5,000,000 us
    ev = [("kernel", "void at::cuda::spin_kernel(long)", 5_000_000, 1),
          ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5_100_000, 100),
          ("kernel", "void upload_score_kernel(Params)", 5_100_100, 50),
          ("kernel", "void vote_window_kernel(Args)", 5_300_000, 200),
          ("gpu_memset", "Memset (Device)", 5_300_100, 10),
          ("kernel", "void at::cuda::spin_kernel(long)", 6_000_000, 1),
          ("kernel", "void vote_window_kernel(Args)", 7_000_000, 5)]
    w = tr.Window(_trace(tmp_path, ev), 100.0)
    assert len(w.kernels()) == 2
    assert w.busy_s() == pytest.approx(350e-6)
    assert w.kernel_s(["vote_window_kernel"]) == pytest.approx(200e-6)
    assert w.by_name()[0][0] == "vote_window_kernel"
    gaps = w.idle_gaps(lambda a, b: f"{a:.2f}-{b:.2f}", top=2)
    assert gaps[0][1] == pytest.approx(0.6998)
    assert gaps[0][0].startswith("100.30-101.00")
    assert gaps[1][1] == pytest.approx(0.19985)


def test_window_needs_both_markers(tmp_path):
    ev = [("kernel", "void at::cuda::spin_kernel(long)", 5_000_000, 1),
          ("kernel", "void vote_window_kernel(Args)", 5_300_000, 200)]
    with pytest.raises(ValueError):
        tr.Window(_trace(tmp_path, ev), 1.0)


def test_every_metric_reads_a_traced_window(tmp_path):
    """The eight readers over a synthetic window: stage sums of 2 samples
    of 1M reads, and a trace with the sparse route's kernels."""
    import run
    from harness import cells, roofline
    from conftest import ROOT
    ev = [("kernel", "void at::cuda::spin_kernel(long)", 0, 1),
          ("kernel", "(anonymous namespace)::upload_score_kernel((anonymous namespace)::Params)", 1_000, 4_000),
          ("kernel", "(anonymous namespace)::vote_window_kernel((anonymous namespace)::Args)", 6_000, 600),
          ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 7_000, 1_000),
          ("kernel", "void at::cuda::spin_kernel(long)", 10_000_000, 1)]
    res = {"reads_done": 2_000_000, "window_s": 10.0, "busy_s": 0.0056,
           "stages": {"index": 0.5, "sort": 1.0, "umi": 0.25, "grouping": 0.75,
                      "materialize.host": 2.0, "materialize": 2.5, "election": 0.1,
                      "assemble": 3.0, "finalize": 0.15, "vote.sync": 0.4},
           "window": tr.Window(_trace(tmp_path, ev), 0.0)}
    ctx = run.Context(res, in_bases=300_000_000, out_bases=50_000_000)
    cell = cells.Cell(cells.load_spec(ROOT), "cfdna_duplex.families")
    got = {k: v["value"] for k, v in run.per_layer(cell, ctx).items()}
    assert got["cli.reads_per_s"] == pytest.approx(200_000.0)
    assert got["io.index_ms_per_Mread"] == pytest.approx(250.0)
    assert got["engine.host_ms_per_Mread"] == pytest.approx(3625.0)
    assert got["engine.umi_ms_per_Mread"] == pytest.approx(500.0)
    assert got["vote.sync_ms_per_Mread"] == pytest.approx(200.0)
    assert got["device.idle_pct"] == pytest.approx(99.944)
    assert res["window"].busy_s() == pytest.approx(0.0056)
    vote_bytes = 3 * 300e6 + 2 * 50e6
    assert got["vote.roofline_pct"] == pytest.approx(100 * vote_bytes / 3.35e12 / 600e-6)
    up_t = roofline.bound_s(4.5 * 300e6, 16 * 300e6)[0]
    assert got["upload.roofline_pct"] == pytest.approx(100 * up_t / 4000e-6)


def test_a_kernel_is_held_against_its_own_launch_counter(tmp_path):
    """Other kernels in the trace never make up for a dropped record of a
    kernel the rooflines read."""
    import run
    ev = [("kernel", "void at::cuda::spin_kernel(long)", 0, 1),
          ("kernel", "(anonymous namespace)::vote_window_kernel((anonymous namespace)::Args)", 1_000, 600),
          ("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 2_000, 10),
          ("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 3_000, 10),
          ("kernel", "(anonymous namespace)::upload_score_kernel((anonymous namespace)::Params)", 4_000, 400),
          ("kernel", "void at::cuda::spin_kernel(long)", 10_000, 1)]
    w = tr.Window(_trace(tmp_path, ev), 0.0)
    launched = {"vote_window_kernel": 2, "vote_kernel": 0, "upload_score_kernel": 1}
    counts, short = run.kernel_counts(w, launched)
    assert counts == {"vote_window_kernel": [1, 2], "upload_score_kernel": [1, 1]}
    assert short == {"vote_window_kernel": [1, 2]}
    launched["vote_window_kernel"] = 1
    assert run.kernel_counts(w, launched)[1] is None


def test_host_clock_reads_cpu_and_collector_seconds():
    import gc
    from harness import samplers
    with samplers.HostClock() as h:
        a = h.read()
        x = sum(i * i for i in range(2_000_000))
        junk = [[i] for i in range(200_000)]
        gc.collect()
        b = h.read()
    d = h.delta(a, b)
    assert x > 0 and junk
    assert d["wall_s"] > 0 and 0 < d["cpu_s"] and d["gc_s"] > 0
    assert "cpu_s" in samplers.host_line(d)
    assert h._gc not in gc.callbacks
