"""The stage table of `cli.main --debug`, captured from a run of the
program on the CPU (data/debug_stderr.txt)."""

import os

import pytest

from harness import stages


def test_parse_captured_table():
    with open(os.path.join(os.path.dirname(__file__), "data", "debug_stderr.txt")) as f:
        got = stages.parse(f.read())
    assert got["index"] == pytest.approx(0.011)
    assert got["umi"] == pytest.approx(0.009)
    assert got["materialize.host"] == pytest.approx(0.021)
    assert got["vote.sync"] == pytest.approx(0.012)
    assert "out.records" in got and len(got) == 18


def test_sums_over_samples():
    a = stages.parse("[stage] umi: 0.500s (summed over windows)\nnoise\n")
    b = stages.parse("[stage] umi: 0.250s (summed over windows)\n"
                     "[stage] sort: 1.000s (summed over windows)\n")
    assert stages.add(stages.add({}, a), b) == {"umi": 0.75, "sort": 1.0}
