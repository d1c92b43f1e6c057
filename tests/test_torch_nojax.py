"""gencore_tpu_torch stands alone: a subprocess blocks JAX and the JAX
package (sys.modules["jax"] = sys.modules["gencore_tpu"] = None), imports
every module of the port (the parallel modules of `--shards`, `--devices`
and the multi-process runs among them), loads the port's own native core
and runs its CLI with --device cpu on a tiny BAM, sharded and streamed;
no source of the port, nor chip_smoke.py, imports JAX, the JAX package,
bench.py or the test suite; and the port builds its native core from its
own csrc/ into build/, never through `make -C native` or a path under
native/."""

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
for n in ("resume", "mesh", "distributed", "multihost", "windows",
          "pipeline", "streaming"):
    assert "gencore_tpu_torch.parallel." + n in names, n
for n in ("entry", "tools.golden_compare", "tools.measure_rss",
          "tools.make_golden", "tools.workloads"):
    assert "gencore_tpu_torch." + n in names, n
from gencore_tpu_torch.io import native
assert native.get_lib() is not None, native.why_not()
print("CORE", native.codec(), native.get_lib()._name)
from gencore_tpu_torch.cli import main
rc = main(sys.argv[1:])
for extra in (["--shards", "2"], ["--stream", "--devices", "2"]):
    rc = rc or main(sys.argv[1:] + extra)
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
    assert m and int(m.group(1)) >= 16, cp.stdout
    core = re.search(r"CORE (libdeflate|zlib) (\S+)", cp.stdout)
    assert core, cp.stdout
    built = pathlib.Path(core.group(2))
    assert built.parent == REPO / "build" / "gencore_tpu_torch"
    assert cp.stderr.count("I/O: native core") == 3, cp.stderr[-3000:]
    assert (tmp_path / "out.bam").stat().st_size > 0


def test_port_builds_its_native_core_from_its_own_sources():
    """No `make -C native`, no path under native/: the loader names only
    csrc/ and build/, and the C++ sources are the port's own."""
    loader = (REPO / "gencore_tpu_torch" / "io" / "native.py").read_text()
    assert "make" not in re.findall(r"[\"']([a-z+]+)[\"']", loader)
    assert not re.search(r"[\"']native[\"']|native/|libgcio\.so\b", loader)
    for src in ("gcio.cpp", "gcio_codec.h"):
        assert (REPO / "gencore_tpu_torch" / "csrc" / src).is_file()
    pat = re.compile(r"make.*-C.*native|[\"'/]native/")
    hits = [str(p) for p in _port_sources() if pat.search(p.read_text())]
    assert hits == []
    shim = (REPO / "gencore_tpu_torch" / "csrc" / "gcio_codec.h").read_text()
    cpp = (REPO / "gencore_tpu_torch" / "csrc" / "gcio.cpp").read_text()
    assert "<zlib.h>" in shim and "<libdeflate.h>" in shim
    assert "libdeflate_" not in cpp and "gc_codec_name" in cpp


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
