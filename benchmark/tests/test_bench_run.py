"""Whole runs of tiny cells on the CPU (the look for a card skipped):
sound runs come out correct, and runs with the timed path broken
underneath, or with the control in the program's place, come out not
correct. `test_control_on_card` runs the control at the cell's own size."""

import os

import pytest

import faults
import run
import tiny

CELLS = ["cfdna_duplex.families"]


@pytest.fixture
def tiny_cells(tmp_path, monkeypatch):
    # the tiny samples are under the CLI's 1 MB streaming threshold
    monkeypatch.setenv("GENCORE_STREAM_THRESHOLD", "0")
    return tiny.make(str(tmp_path))


def one(cells, workload, seed, entry=None):
    spec, bench = cells
    return run.run_cell(workload, seed, 0.5, False, device="cpu", entry=entry,
                        spec=spec, workers=2, bench_dir=bench)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_cells, workload):
    out = one(tiny_cells, workload, 2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"host_peak_rss_MB", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault,number", [
    (faults.altered_answer, "records_differing"),
    (faults.half_left_out, "records_differing"),
    (faults.state_unchanged, "records_differing")])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(tiny_cells, workload, fault, number):
    from gencore_tpu_torch import cli
    out = one(tiny_cells, workload, 5, entry=fault(cli.main))
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_second_run_of_a_seed_reuses_its_sample_and_reference(tiny_cells):
    spec, bench = tiny_cells
    first = one(tiny_cells, CELLS[0], 13)
    cell = run.cells.Cell(spec, CELLS[0], bench)
    where = run.seed_dir(cell, 13, bench)
    kept = {f: os.path.getmtime(os.path.join(where, f))
            for f in ("sample.bam", "ref.digests", "ref.json")}
    again = one(tiny_cells, CELLS[0], 13)
    assert first["correct"] and again["correct"]
    assert kept == {f: os.path.getmtime(os.path.join(where, f)) for f in kept}
    # a fault is caught against the kept reference too
    from gencore_tpu_torch import cli
    bad = one(tiny_cells, CELLS[0], 13, entry=faults.altered_answer(cli.main))
    assert bad["checks"]["records_differing"]["value"] == 1


def test_cache_keeps_the_newest_seeds(tiny_cells, monkeypatch):
    spec, bench = tiny_cells
    monkeypatch.setattr(run, "KEEP_SEEDS", 2)
    for seed in (21, 22, 23):
        one(tiny_cells, CELLS[0], seed)
    cell = run.cells.Cell(spec, CELLS[0], bench)
    top = os.path.dirname(run.seed_dir(cell, 23, bench))
    assert sorted(os.listdir(top)) == ["22", "23"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_cells, workload):
    out = one(tiny_cells, workload, 7, entry=faults.control())
    assert not out["correct"]
    assert out["checks"]["records_differing"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000000101, 3000000102, 3000000103])
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_card(card, workload, seed):
    """The control at the cell's own size on the card; prints its reading."""
    out = run.run_cell(workload, seed, 1.0, False,
                       entry=faults.control(workers=os.cpu_count() or 1))
    print(f"control {workload} seed {seed}: {out['checks']}")
    assert not out["correct"]
