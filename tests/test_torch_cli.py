"""The port's CLI (`--device cpu`) against the JAX package's CLI on the
same inputs, through the streaming path and through the in-memory window
pipeline: output BAMs equal after BGZF inflation (and as files when both
packages deflate with the same library), JSON reports equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gencore_tpu import cli as jax_cli
from gencore_tpu_torch import cli as port_cli
from gencore_tpu.io import native as jax_native
from gencore_tpu_torch.io import native
from tests.test_engine_equivalence import make_random_workload
from tests.test_torch_native import inflate, same_codec

torch.set_num_threads(1)


def _inputs(tmp_path):
    sb = make_random_workload(91, n_fragments=150, umi_mode="duplex",
                              contig_len=500_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    fa_path = str(tmp_path / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    return bam_path, fa_path


def _run(main, tmp_path, tag, bam_path, fa_path, extra):
    out = str(tmp_path / f"{tag}.bam")
    js = str(tmp_path / f"{tag}.json")
    rc = main(["-i", bam_path, "-o", out, "-r", fa_path, "-j", js,
               "--html", str(tmp_path / f"{tag}.html"), *extra])
    assert rc == 0
    with open(out, "rb") as f:
        body = f.read()
    with open(js) as f:
        report = [ln for ln in f.read().splitlines()
                  if '"command"' not in ln]
    return inflate(out), report, body


@pytest.mark.parametrize("mode", ["stream", "windows"])
def test_port_cli_matches_jax_cli(tmp_path, monkeypatch, mode):
    assert native.get_lib() is not None, native.why_not()
    monkeypatch.setenv("GENCORE_COMPILE_CACHE", "0")
    if mode == "windows":
        monkeypatch.setenv("GENCORE_NO_STREAM", "1")
    extra = ["--stream"] if mode == "stream" else ["--windows", "3"]
    bam_path, fa_path = _inputs(tmp_path)
    # the JAX CLI streams only with its own native core; where that did
    # not load, its window pipeline gives the same records
    jax_extra = (extra if mode == "windows"
                 or jax_native.get_lib() is not None else ["--windows", "3"])
    want = _run(jax_cli.main, tmp_path, "jax", bam_path, fa_path, jax_extra)
    got = _run(port_cli.main, tmp_path, "port", bam_path, fa_path,
               extra + ["--device", "cpu"])
    assert got[0] == want[0] and len(got[0]) > 10_000
    assert got[1] == want[1]
    if same_codec():
        assert got[2] == want[2]


def test_port_cli_default_device_and_unported_flags(tmp_path):
    bam_path, fa_path = _inputs(tmp_path)
    args = ["-i", bam_path, "-o", str(tmp_path / "o.bam"), "-r", fa_path,
            "-j", str(tmp_path / "o.json"), "--html", str(tmp_path / "o.html")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(args)
    # flags that once raised NotImplementedError now run, and say which
    # I/O path they took
    for flag in ("--shards", "--devices"):
        assert port_cli.main(args + [flag, "2", "--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(args + ["--devices", "2"])
    assert port_cli.main(["test"]) == 0


def test_port_cli_names_its_io_path_and_codec(tmp_path, monkeypatch, capsys):
    bam_path, fa_path = _inputs(tmp_path)
    _run(port_cli.main, tmp_path, "a", bam_path, fa_path,
         ["--stream", "--device", "cpu"])
    err = capsys.readouterr().err
    assert err.count("I/O: ") == 1
    assert f"I/O: native core ({native.codec()}), streaming path" in err
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "BUILD_LOG", "no compiler here")
    _run(port_cli.main, tmp_path, "b", bam_path, fa_path,
         ["--windows", "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert ("I/O: pure-Python codec (native core unavailable: no compiler "
            "here), in-memory window pipeline") in err
    assert inflate(tmp_path / "a.bam") == inflate(tmp_path / "b.bam")


def test_port_cli_oracle_matches_port_engine(tmp_path):
    """`--oracle` reuses the scalar OracleEngine; the port's engine output
    equals it byte for byte."""
    bam_path, fa_path = _inputs(tmp_path)
    o = _run(port_cli.main, tmp_path, "oracle", bam_path, fa_path,
             ["--oracle", "--windows", "1"])
    p = _run(port_cli.main, tmp_path, "port1", bam_path, fa_path,
             ["--windows", "1", "--device", "cpu"])
    assert o[0] == p[0]
    assert o[1] == p[1]
    assert np.frombuffer(o[0], np.uint8).size > 0


def test_port_cli_pipes_stream(tmp_path):
    """`-i - -o -` through the port's CLI takes the streaming path
    (stdin spooled, incremental BGZF writes to stdout) and writes the
    same bytes as its file->file streaming run."""
    assert native.get_lib() is not None, native.why_not()
    bam_path, fa_path = _inputs(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "GENCORE_STREAM_THRESHOLD": "1",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    common = ["-r", fa_path, "--debug", "--device", "cpu"]
    out_file = str(tmp_path / "file.bam")
    pf = subprocess.run(
        [sys.executable, "-m", "gencore_tpu_torch", "-i", bam_path, "-o",
         out_file, "-j", str(tmp_path / "f.json"), "-h",
         str(tmp_path / "f.html"), *common],
        capture_output=True, timeout=300, env=env, cwd=str(tmp_path))
    assert pf.returncode == 0, pf.stderr.decode()[-800:]
    assert b"[stage] index" in pf.stderr
    with open(bam_path, "rb") as fin:
        pp = subprocess.run(
            [sys.executable, "-m", "gencore_tpu_torch", "-i", "-", "-o", "-",
             "-j", str(tmp_path / "p.json"), "-h", str(tmp_path / "p.html"),
             *common],
            stdin=fin, capture_output=True, timeout=300, env=env,
            cwd=str(tmp_path))
    assert pp.returncode == 0, pp.stderr.decode()[-800:]
    assert b"[stage] index" in pp.stderr
    with open(out_file, "rb") as f:
        assert pp.stdout == f.read()


def test_port_cli_long_amplicon_matches_golden(tmp_path):
    """The long_amplicon panel (2x300 reads: every window stages dense at
    L = 320) through the port's CLI on the CPU, its default streaming
    path: the generated input and the output records and report equal the
    golden digests that the JAX CLI made (testdata/long_amplicon.json),
    as chip_smoke.py's phase 7b holds the card to them."""
    import json

    from gencore_tpu_torch.tools.make_golden import (digest_records,
                                                     digest_report,
                                                     golden_path,
                                                     make_workload)
    with open(golden_path("long_amplicon")) as f:
        golden = json.load(f)
    bam_path, fa_path = make_workload("long_amplicon", str(tmp_path))
    assert digest_records(bam_path) == (golden["input"]["records"],
                                        golden["input"]["sha256"])
    out, js = str(tmp_path / "out.bam"), str(tmp_path / "out.json")
    assert port_cli.main(["-i", bam_path, "-o", out, "-r", fa_path, "-j", js,
                          "--html", str(tmp_path / "out.html"),
                          "--device", "cpu"]) == 0
    assert digest_records(out) == (golden["output"]["records"],
                                   golden["output"]["sha256"])
    assert digest_report(js) == golden["report_stats_sha256"]
