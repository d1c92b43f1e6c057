"""The port's CLI (`--device cpu`) against the JAX package's CLI over the
case matrix of gencore_tpu_torch/tools/golden_compare.py at its quick size
(300 fragments): every case on the port's default route, and three cases
on `--stream`, each held to the JAX CLI's default run of the same input.
Compared: the ordered output records (SAM text for SAM output), the JSON
report without its `command` line and the HTML report after
`normalize_html`. Tolerance 0."""

import contextlib
import io
import os

import pytest
import torch

from gencore_tpu import cli as jax_cli
from gencore_tpu_torch.io.sam import open_alignment
from gencore_tpu_torch.tools import golden_compare as gc

torch.set_num_threads(1)


def _outputs(case, stem):
    """(ordered records or SAM lines, JSON lines without `command`,
    normalized HTML) of one run's outputs at stem.*"""
    if case.sam_out:
        with open(stem + ".sam") as f:
            recs = f.read().splitlines()
    else:
        b = open_alignment(stem + ".bam").read_all()
        recs = [b.record_bytes(i) for i in range(b.n)]
    with open(stem + ".json") as f:
        report = [ln for ln in f.read().splitlines() if '"command"' not in ln]
    return recs, report, gc.normalize_html(stem + ".html")


def _run_both(case, route, wd):
    inp, fa, bed, _ = gc.prepare(case, wd, quick=True)
    jstem = os.path.join(wd, f"{case.name}_jax")
    with contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main(gc.cli_args(case, "default", inp, fa, bed,
                                        jstem)) == 0
    got = gc.run_route(case, route, wd, device="cpu", quick=True)
    pstem = os.path.join(wd, f"{case.name}_{route}_port")
    return _outputs(case, pstem), _outputs(case, jstem), got


def _assert_equal(got, want):
    (grecs, grep, ghtml), (wrecs, wrep, whtml) = got, want
    assert len(grecs) == len(wrecs)
    first = next((i for i, (g, w) in enumerate(zip(grecs, wrecs)) if g != w),
                 None)
    assert first is None, f"first differing record: {first}"
    assert grep == wrep
    assert ghtml == whtml


@pytest.mark.parametrize("name", list(gc.CASES))
def test_port_cli_matches_jax_cli_on_case(tmp_path, monkeypatch, name):
    monkeypatch.setenv("GENCORE_COMPILE_CACHE", "0")
    case = gc.CASES[name]
    got, want, res = _run_both(case, "default", str(tmp_path))
    _assert_equal(got, want)
    assert "in-memory single-shot run" in res["io_line"]
    if name != "duplex_only":   # no duplex pair in its input: no output
        assert len(got[0]) > 100


@pytest.mark.parametrize("name", ["duplex_umi", "thresholds", "no_ref"])
def test_port_cli_streaming_matches_jax_cli_on_case(tmp_path, monkeypatch,
                                                    name):
    monkeypatch.setenv("GENCORE_COMPILE_CACHE", "0")
    case = gc.CASES[name]
    got, want, res = _run_both(case, "stream", str(tmp_path))
    _assert_equal(got, want)
    assert "streaming path" in res["io_line"]
