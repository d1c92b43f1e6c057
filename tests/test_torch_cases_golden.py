"""The committed golden digests of the case matrix
(gencore_tpu_torch/testdata/cases/<case>.json, made by the JAX CLI on the
CPU through `make_golden --case`): every case's generator still makes
the input the golden was made from; the duplex-pair goldens count merged
duplex reads; three cases recomputed at full size on every route they
take, with the port's CLI on the CPU, equal their goldens; and SAM input
gives the records of the BAM-input run."""

import json
import os

import pytest
import torch

from gencore_tpu_torch.io.sam import open_alignment
from gencore_tpu_torch.tools import golden_compare as gc
from gencore_tpu_torch.tools.make_golden import digest_report

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(gc.CASES))
def test_case_input_matches_its_golden(tmp_path, name):
    golden = gc.load_golden(name)
    case = gc.CASES[name]
    _, _, _, d_in = gc.prepare(case, str(tmp_path))
    assert d_in == golden["input"]
    assert golden["cli_args"] == list(case.args)
    assert golden["made_by"].startswith("python -m gencore_tpu.cli")
    assert set(gc.DIGEST_KEYS) <= set(golden)


def test_every_case_has_a_golden_and_no_other():
    files = sorted(f[:-5] for f in os.listdir(gc.CASES_DIR)
                   if f.endswith(".json"))
    assert files == sorted(gc.CASES)
    assert len(files) == 15
    for name in files:
        with open(gc.golden_path(name)) as f:
            assert json.load(f)["workload"].startswith(
                f"golden_compare case {name}:")


@pytest.mark.parametrize("name", ["duplex_pairs", "duplex_pairs_x"])
def test_duplex_pair_goldens_hold_merged_duplexes(name):
    """The JAX CLI's report for the duplex-pair cases counts duplex
    consensus reads, so the duplex step is exercised, not a no-op; with
    -x it writes no single-strand read."""
    summary = gc.load_golden(name)["summary"]
    assert summary["duplex_consensus_sequence"] > 0
    if "-x" in gc.CASES[name].args:
        assert summary["single_stranded_consensus_sequence"] == 0
    else:
        assert summary["single_stranded_consensus_sequence"] > 0


@pytest.mark.parametrize("name", ["thresholds", "big_mixed",
                                  "duplex_pairs_x"])
def test_port_cli_matches_golden_at_full_size(tmp_path, monkeypatch, name):
    monkeypatch.setenv("GENCORE_COMPILE_CACHE", "0")
    golden = gc.load_golden(name)
    case = gc.CASES[name]
    for route in case.routes:
        got = gc.run_route(case, route, str(tmp_path), device="cpu")
        assert gc.differences(got, golden) == [], route


def _records_bin_blanked(path):
    """Decoded records with the bin field (body bytes 10-11) zeroed: the
    generator writes bin 0 and the SAM reader computes it (reg2bin)."""
    b = open_alignment(path).read_all()
    out = []
    for i in range(b.n):
        body = bytearray(b.record_bytes(i))
        body[10:12] = b"\0\0"
        out.append(bytes(body))
    return out


def test_sam_input_gives_the_bam_input_records(tmp_path):
    wd = str(tmp_path)
    for name in ("duplex_umi", "sam_in"):
        gc.run_route(gc.CASES[name], "default", wd, device="cpu", quick=True)
    bam_run = os.path.join(wd, "duplex_umi_default_port")
    sam_run = os.path.join(wd, "sam_in_default_port")
    a = _records_bin_blanked(bam_run + ".bam")
    assert a == _records_bin_blanked(sam_run + ".bam") and len(a) > 100
    assert digest_report(bam_run + ".json") == digest_report(
        sam_run + ".json")
    assert gc.digest_html(bam_run + ".html") == gc.digest_html(
        sam_run + ".html")
