"""Cells, configurations, traffic mixes and per-layer metrics are found by
name; a new one is new files and new entries, with no edit."""

import json
import os
import shutil

import pytest

from conftest import BENCH, ROOT
from harness import cells

NAME = __import__("re").compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_repo_spec_is_whole():
    spec = cells.load_spec(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cfgs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs and w["chips"] == 1
        c = cells.Cell(spec, w["name"])
        assert c.config["name"] == w["config"]
        assert set(c.config["reduced"]) == set(c.config_entry["reduced"])
        assert {m["name"] for m in c.end_to_end()} == {"host_peak_rss_MB", "setup_s"}
        assert len(c.per_layer()) == 8
    for m in spec["per_layer"]:
        mod = cells.load_metric(BENCH, m["name"])
        assert (mod.SOURCE, mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["source"], m["unit"], m["layer"], m["moves"])
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"])


def test_new_cell_metric_and_traffic_are_files_only(tmp_path):
    spec = cells.load_spec(ROOT)
    bench = tmp_path / "bench"
    shutil.copytree(os.path.join(BENCH, "metrics"), bench / "metrics")
    shutil.copytree(os.path.join(BENCH, "traffic"), bench / "traffic")
    (bench / "traffic" / "deep.json").write_text(json.dumps(
        {"name": "deep", "molecules_per_target": 10,
         "family": {"kind": "uniform", "lo": 1, "hi": 2},
         "cli": ["--windows", "1"]}))
    (bench / "metrics" / "extra.sort_ms_per_Mread.py").write_text(
        'SOURCE = "program_span"\nUNIT = "ms/Mread"\nLAYER = "host"\n'
        'MOVES = "reads_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx.stage_ms_per_mread(["sort"])\n')
    spec["workloads"].append({"name": "cfdna_duplex.deep", "config": "cfdna_duplex_2x150",
                              "traffic": "deep", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "extra.sort_ms_per_Mread", "unit": "ms/Mread",
                              "better": "lower", "source": "program_span",
                              "layer": "host", "moves": "reads_per_s"})
    c = cells.Cell(spec, "cfdna_duplex.deep", str(bench))
    assert c.traffic["molecules_per_target"] == 10
    assert c.cli_args()[-2:] == ["--windows", "1"]
    names = [m["name"] for m in c.per_layer()]
    assert "extra.sort_ms_per_Mread" in names and "vote.roofline_pct" not in names

    class Ctx:
        reads = 2_000_000
        stages = {"sort": 0.5}

        def stage_ms_per_mread(self, n):
            return 1e3 * sum(self.stages[k] for k in n) / (self.reads / 1e6)
    assert c.metric_module("extra.sort_ms_per_Mread").read(Ctx()) == pytest.approx(250.0)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.Cell(cells.load_spec(ROOT), "no.such_cell")
