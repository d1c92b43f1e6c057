"""The port's CLI (`--device cpu`) against the JAX package's CLI on the
same inputs, through the streaming path and through the in-memory window
pipeline: output BAM bytes and JSON reports equal."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gencore_tpu import cli as jax_cli
from gencore_tpu_torch import cli as port_cli
from gencore_tpu_torch.io import native
from tests.test_engine_equivalence import make_random_workload

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
    return body, report


@pytest.mark.parametrize("mode", ["stream", "windows"])
def test_port_cli_matches_jax_cli(tmp_path, monkeypatch, mode):
    if mode == "stream" and native.get_lib() is None:
        pytest.skip("streaming needs the native I/O core")
    monkeypatch.setenv("GENCORE_COMPILE_CACHE", "0")
    if mode == "windows":
        monkeypatch.setenv("GENCORE_NO_STREAM", "1")
    extra = ["--stream"] if mode == "stream" else ["--windows", "3"]
    bam_path, fa_path = _inputs(tmp_path)
    want = _run(jax_cli.main, tmp_path, "jax", bam_path, fa_path, extra)
    got = _run(port_cli.main, tmp_path, "port", bam_path, fa_path,
               extra + ["--device", "cpu"])
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_port_cli_default_device_and_unported_flags(tmp_path):
    bam_path, fa_path = _inputs(tmp_path)
    args = ["-i", bam_path, "-o", str(tmp_path / "o.bam"), "-r", fa_path]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(args)
    for flag in ("--shards", "--devices"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_cli.main(args + [flag, "2", "--device", "cpu"])
    assert port_cli.main(["test"]) == 0


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
    if native.get_lib() is None:
        pytest.skip("streaming needs the native I/O core")
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
