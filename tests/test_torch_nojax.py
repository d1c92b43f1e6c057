"""gencore_tpu_torch stands alone: a subprocess blocks JAX and the JAX
package (sys.modules["jax"] = sys.modules["gencore_tpu"] = None), imports
every module of the port and runs its CLI with --device cpu on a tiny BAM;
and no source of the port, nor chip_smoke.py, imports JAX, the JAX package,
bench.py or the test suite."""

import os
import pathlib
import re
import subprocess
import sys

from tests.datagen import SyntheticBam

REPO = pathlib.Path(__file__).resolve().parent.parent

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["gencore_tpu"] = None
import gencore_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    gencore_tpu_torch.__path__, "gencore_tpu_torch."))
for n in names:
    importlib.import_module(n)
from gencore_tpu_torch.cli import main
rc = main(sys.argv[1:])
loaded = sorted(k for k, v in sys.modules.items()
                if v is not None and k.split(".")[0] in
                ("jax", "jaxlib", "gencore_tpu", "bench", "tests"))
print("MODULES", len(names), "JAX", loaded)
sys.exit(rc)
"""


def test_port_runs_with_jax_blocked(tmp_path):
    sb = SyntheticBam(seed=3, contig_len=20_000)
    for k in range(12):
        sb.add_pair(0, 500 + 97 * k, 650 + 97 * k, umi="ACGT_TTGA")
        sb.add_pair(0, 500 + 97 * k, 650 + 97 * k, umi="ACGT_TTGA",
                    n_errors=1)
    sb.write_bam(str(tmp_path / "in.bam"))
    sb.write_fasta(str(tmp_path / "ref.fa"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cp = subprocess.run(
        [sys.executable, "-c", _CHILD, "-i", str(tmp_path / "in.bam"),
         "-o", str(tmp_path / "out.bam"), "-r", str(tmp_path / "ref.fa"),
         "-j", str(tmp_path / "r.json"), "--html", str(tmp_path / "r.html"),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert cp.returncode == 0, cp.stderr[-3000:]
    m = re.search(r"MODULES (\d+) JAX \[\]", cp.stdout)
    assert m and int(m.group(1)) >= 12, cp.stdout
    assert (tmp_path / "out.bam").stat().st_size > 0


def _port_sources():
    return sorted((REPO / "gencore_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    hits = [str(p) for p in _port_sources() if pat.search(p.read_text())]
    assert hits == []


def test_port_sources_never_import_the_jax_package_bench_or_tests():
    """The port keeps its own copies of the host modules it shares with
    gencore_tpu; chip_smoke.py makes its workloads through the port."""
    pat = re.compile(
        r"^\s*(?:from|import)\s+(?:gencore_tpu|bench|tests)\b(?!_)"
        r"|import_module\(\s*['\"](?:gencore_tpu|bench|tests)\b(?!_)", re.M)
    hits = [f"{p}: {m.group(0).strip()}" for p in _port_sources()
            for m in pat.finditer(p.read_text())]
    assert hits == []
