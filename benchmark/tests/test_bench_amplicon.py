"""The MiSeq 2x300 UMI amplicon configuration and its cell
`amplicon_2x300.umi`: the entries that name them, and the generator at a
small size of it. And the per-layer metric that reads the bytes downloaded
per read, on hand-made spans, and nothing where the spans or their
attribute are absent."""

import json
import sys
import types
from collections import namedtuple

import numpy as np
import pytest

from conftest import BENCH, ROOT, bench_json
from harness import cells, gen, spans
from reference import bam as bamio

NEW = ("wire.d2h_bytes_per_read",)
CELLS = ["cfdna_duplex.families", "cfdna_duplex.singletons",
         "amplicon_2x300.umi"]
Span = namedtuple("Span", "id parent sample window thread name t0_ns t1_ns "
                          "cpu_ns attrs")
S = 1_000_000_000   # ns a second


def _load(kind, name):
    with open(bench_json(kind, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    cfg = _load("configs", "miseq_amplicon_umi_2x300")
    cfg["genome"]["genome_bp"] = 2_000_000
    cfg["panel"]["targets"] = 4
    traffic = _load("traffic", "amplicon_families")
    traffic["molecules_per_target"] = 40
    path = str(tmp_path_factory.mktemp("amp") / "a.bam")
    made = gen.sample(cfg, traffic, 2**31 + 101, path)
    return cfg, made, bamio.BamReader(path).read_all()


def test_the_configuration_and_its_traffic_hold_the_stated_shapes():
    cfg = _load("configs", "miseq_amplicon_umi_2x300")
    assert 0 < len(cfg["source"]) <= 200
    assert set(cfg["reduced"]) == {"genome", "panel.targets"}
    assert cfg["panel"] == {"kind": "amplicon", "targets": 30,
                            "insert_bp": [400, 560]}
    assert cfg["read_bp"] == 300 and cfg["genome"]["genome_bp"] == 64_000_000
    assert cfg["umi"]["mode"] == "single" and cfg["umi"]["halves"] == [12]
    assert cfg["errors"] == {"mode": "per_base", "rate": 0.003}
    assert cfg["cli"] == _load("configs", "cfdna_duplex_2x150")["cli"]
    assert cfg["assumed"] and cfg["deployment"]
    traffic = _load("traffic", "amplicon_families")
    assert traffic["molecules_per_target"] == 1000
    assert traffic["family"] == {"kind": "one_plus_poisson",
                                 "mean_extra": 9.0}
    spec = cells.load_spec(ROOT)
    entry = {c["name"]: c for c in spec["configs"]}[cfg["name"]]
    assert entry["source"] == cfg["source"]
    assert set(entry["reduced"]) == set(cfg["reduced"])
    cell = {w["name"]: w for w in spec["workloads"]}["amplicon_2x300.umi"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        cfg["name"], traffic["name"], 1)
    # the dense route's kernels are read by the rooflines that are there
    for name in ("upload.roofline_pct", "vote.roofline_pct"):
        m = {m["name"]: m for m in spec["per_layer"]}[name]
        assert "amplicon_2x300.umi" in m["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_metric_is_the_cells_as_its_reader_says(cell):
    c = cells.Cell(cells.load_spec(ROOT), cell)
    got = {m["name"]: m for m in c.per_layer()}
    for name in NEW:
        mod = cells.load_metric(BENCH, name)
        m = got[name]
        assert (mod.SOURCE, mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["source"], m["unit"], m["layer"], m["moves"])
        assert m["workloads"] == CELLS


def test_reads_are_300_bases_with_mates_overlapping_40_to_200(sample):
    _cfg, made, b = sample
    assert b.n == made["reads"] and (b.l_qseq == 300).all()
    left = b.flag == 99
    overlap = 300 - (b.mpos[left] - b.pos[left])
    assert overlap.min() >= 40 and overlap.max() <= 200
    # an amplicon is one position cluster: one (pos, mpos) for its pairs
    assert len(set(zip(b.pos[left].tolist(), b.mpos[left].tolist()))) == 4


def test_each_read_carries_one_12_base_umi(sample):
    _cfg, _made, b = sample
    for i in range(0, b.n, 7):
        umi = b.qname(i).decode().rsplit(":UMI_", 1)[1]
        assert len(umi) == 12 and set(umi) <= set("ACGT")


def test_qualities_take_17_or_more_values_with_three_quarters_at_q30(sample):
    cfg, _made, b = sample
    q = np.concatenate([b.qual(i) for i in range(0, b.n, 3)])
    values = np.unique(q)
    assert len(values) >= 17 and values.min() >= 2 and values.max() <= 38
    assert set(values.tolist()) <= set(cfg["quals"]["values"])
    assert 0.72 <= (q >= 30).mean() <= 0.78


# the readers, on a hand-made window

class Ctx:
    reads = 1_000_000

    def __init__(self, spans=None):
        self.spans = spans


@pytest.fixture(scope="module")
def readers():
    return {n: cells.load_metric(BENCH, n) for n in NEW}


def _grouping(i, t0_s, t1_s, attrs):
    return Span(i, 0, 1, i, "MainThread", "grouping", int(t0_s * S),
                int(t1_s * S), int((t1_s - t0_s) * S), attrs)


def _sample(i, t0_s, attrs):
    return Span(i, 0, i, -1, "MainThread", "cli.sample", int(t0_s * S),
                int((t0_s + 1) * S), S, attrs)


def test_d2h_bytes_per_read_sums_the_samples_downloads(readers):
    sp = [_sample(1, 101, {"wire.d2hMB": 20.0, "wire.h2dMB": 900.0}),
          _sample(2, 102, {"wire.d2hMB": 30.5}),
          _grouping(3, 101, 102, {"wire.d2hMB": 1e6})]
    assert readers["wire.d2h_bytes_per_read"].read(Ctx(sp)) == \
        pytest.approx(50.5)


def test_d2h_bytes_per_read_gives_nothing_without_its_attribute(readers):
    read = readers["wire.d2h_bytes_per_read"].read
    assert read(Ctx([])) is None
    # the parent's sample spans carry no counters
    assert read(Ctx([_sample(1, 101, None)])) is None
    assert read(Ctx([_sample(1, 101, {"wire.h2dMB": 900.0})])) is None


def test_d2h_bytes_per_read_counts_the_windows_samples_alone(readers,
                                                            monkeypatch):
    class W:
        host_t0 = 100.0

    class FromProgram:
        reads = 1_000_000
        window = W()
    rec = types.SimpleNamespace(spans=lambda: [
        _sample(1, 99, {"wire.d2hMB": 7.0}),     # the warm-up sample
        _sample(2, 101, {"wire.d2hMB": 3.0})])
    monkeypatch.setitem(sys.modules, spans.RECORDER, rec)
    assert readers["wire.d2h_bytes_per_read"].read(FromProgram()) == \
        pytest.approx(3.0)
