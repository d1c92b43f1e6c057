"""The port's own native I/O core (gencore_tpu_torch/csrc/gcio.cpp, built
by gencore_tpu_torch/io/native.py), with each DEFLATE codec (libdeflate,
zlib), against the pure-Python BGZF codec, against numpy references, and
against the JAX package's core where that one loaded: BGZF round trips,
block table and ranged decode, gc_bam_index columns, NM/MI/nibble scans.
All of it is byte and integer work: tolerance 0. Compressed bytes are
never compared across codecs, only what they inflate to.

Also: eight processes calling get_lib() at once on an empty build
directory all load a whole library."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from gencore_tpu.io import native as jax_native
from gencore_tpu_torch.io import bam as tbam
from gencore_tpu_torch.io import bgzf as tbgzf
from gencore_tpu_torch.io import native
from tests.test_engine_equivalence import make_random_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ["libdeflate", "zlib"]


def inflate(path) -> bytes:
    """A BGZF file's plain bytes through the pure-Python codec."""
    return tbgzf.decompress_file(str(path))


def same_codec() -> bool:
    """Whether both packages deflate with the same library here, so that
    even their compressed bytes must agree: both through libdeflate, or
    both through Python's zlib."""
    jax_codec = "libdeflate" if jax_native.get_lib() is not None else None
    return native.codec() == jax_codec


@pytest.fixture(params=CODECS)
def core(request, monkeypatch):
    """The port's native module with the library of one codec loaded."""
    monkeypatch.setattr(native, "_lib", native.load(request.param))
    monkeypatch.setattr(native, "_tried", True)
    assert native.codec() == request.param
    return native


def _jax_core():
    return jax_native if jax_native.get_lib() is not None else None


def _workload_bam(tmp_path, seed, **kw):
    sb = make_random_workload(seed, **kw)
    path = str(tmp_path / "in.bam")
    sb.write_bam(path)
    return path


def _body(payload):
    """Offset of the first record of a decompressed BAM."""
    l_text = struct.unpack("<i", payload[4:8].tobytes())[0]
    q = 8 + l_text
    n_ref = struct.unpack("<i", payload[q:q + 4].tobytes())[0]
    q += 4
    for _ in range(n_ref):
        q += 4 + struct.unpack("<i", payload[q:q + 4].tobytes())[0] + 4
    return q


def test_default_build_loads_and_names_its_codec():
    assert native.get_lib() is not None, native.why_not()
    assert native.codec() in CODECS
    assert native.why_not() == ""
    path = native.get_lib()._name
    assert path == native.build(native.codec())
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.sep + "native" + os.sep not in path
    assert native.library_path("zlib") != native.library_path("libdeflate")
    with pytest.raises(ValueError, match="unknown codec"):
        native.build("brotli")


def test_bgzf_round_trip(core, tmp_path):
    rng = np.random.default_rng(1)
    payload = np.concatenate([
        rng.integers(0, 256, size=300_000, dtype=np.uint8),
        rng.integers(0, 4, size=700_000, dtype=np.uint8)])
    p = str(tmp_path / "x.bgzf")
    assert core.bgzf_write(p, payload)
    assert (core.bgzf_read(p) == payload).all()
    assert inflate(p) == payload.tobytes()
    p2 = str(tmp_path / "y.bgzf")
    tbgzf.compress_to_file(p2, payload.tobytes())
    assert (core.bgzf_read(p2) == payload).all()
    jc = _jax_core()
    if jc is not None:
        assert (jc.bgzf_read(p) == payload).all()
        p3 = str(tmp_path / "z.bgzf")
        assert jc.bgzf_write(p3, payload)
        assert (core.bgzf_read(p3) == payload).all()


def test_both_codecs_read_each_other(tmp_path):
    rng = np.random.default_rng(2)
    payload = rng.integers(0, 16, size=500_000, dtype=np.uint8)
    libs = {c: native.load(c) for c in CODECS}
    plain = {}
    for w in CODECS:
        p = str(tmp_path / f"{w}.bgzf").encode()
        assert libs[w].gc_bgzf_write(p, payload.ctypes.data, len(payload),
                                     6, 0) == 0
        plain[w] = inflate(p.decode())
        for r in CODECS:
            n = native.ctypes.c_int64(0)
            ptr = libs[r].gc_bgzf_read(p, native.ctypes.byref(n), 2)
            assert ptr and n.value == len(payload), (w, r)
            got = np.ctypeslib.as_array(ptr, shape=(n.value,)).copy()
            libs[r].gc_free(ptr)
            assert (got == payload).all(), (w, r)
    assert plain["zlib"] == plain["libdeflate"] == payload.tobytes()


def test_corrupt_block_is_refused(core, tmp_path):
    p = str(tmp_path / "x.bgzf")
    payload = np.arange(200_000, dtype=np.uint32).view(np.uint8)
    assert core.bgzf_write(p, payload)
    raw = bytearray(open(p, "rb").read())
    for k in range(40, 60):
        raw[k] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    assert core.bgzf_read(p) is None


def test_block_table_and_ranged_decode(core, tmp_path):
    bam_path = _workload_bam(tmp_path, 90, n_fragments=150, umi_mode="plain",
                             contig_len=300_000, n_contigs=2)
    table, total = core.bgzf_block_table(bam_path)
    full = core.bgzf_read(bam_path)
    assert total == len(full) and full.tobytes() == inflate(bam_path)
    mid = len(table) // 2
    a = core.bgzf_read_blocks(bam_path, 0, mid, int(table[mid, 1]))
    b = core.bgzf_read_blocks(bam_path, mid, len(table),
                              total - int(table[mid, 1]))
    assert (np.concatenate([a, b]) == full).all()
    size = os.path.getsize(bam_path)
    c = core.bgzf_read_span(bam_path, int(table[mid, 0]), size,
                            total - int(table[mid, 1]))
    assert (c == b).all()
    jc = _jax_core()
    if jc is not None:
        jtable, jtotal = jc.bgzf_block_table(bam_path)
        assert jtotal == total and (jtable == table).all()


def test_incremental_bgzf_writer(core, tmp_path):
    rng = np.random.default_rng(0)
    parts = [rng.integers(0, 255, rng.integers(10, 200_000), dtype=np.uint8)
             for _ in range(5)]
    p1 = str(tmp_path / "inc.bgzf")
    assert core.bgzf_write_ex(p1, parts[0], append=False, write_eof=False)
    for p in parts[1:]:
        assert core.bgzf_write_ex(p1, p, append=True, write_eof=False)
    assert core.bgzf_write_ex(p1, np.zeros(0, dtype=np.uint8), append=True,
                              write_eof=True)
    assert (core.bgzf_read(p1) == np.concatenate(parts)).all()
    assert inflate(p1) == np.concatenate(parts).tobytes()
    with open(p1, "rb") as f:
        assert f.read()[-28:] == tbgzf.BGZF_EOF


def test_bam_index_columns(core, tmp_path):
    bam_path = _workload_bam(tmp_path, 43, n_fragments=400,
                             contig_len=200_000, n_contigs=2)
    payload = core.bgzf_read(bam_path)
    q = _body(payload)
    bounds, cols = core.bam_index(payload[q:], 0)
    n = len(bounds) - 1
    off = bounds[:n]
    end = np.empty(n, dtype=np.int64)
    end[:-1] = bounds[1:n] - 4
    end[-1] = bounds[-1]
    batch = tbam.RecordBatch(payload[q:], off, end)
    assert batch.n == n > 0
    for k in ("tid", "pos", "mtid", "mpos", "isize", "flag", "l_qseq"):
        assert (cols[k] == getattr(batch, k).astype(np.int64)).all(), k
    # NM through the scan entry point and through the fused index agree
    vals, _ = core.nm_extract(batch.data, batch.aux_off, batch.end)
    assert (cols["nm"].astype(np.int64) == vals).all()
    assert (core.bam_scan(payload, q) - q == bounds).all()
    jc = _jax_core()
    if jc is not None:
        jbounds, jcols = jc.bam_index(payload[q:], 0)
        assert (jbounds == bounds).all()
        for k in cols:
            assert (jcols[k] == cols[k]).all(), k


def test_bam_reader_native_equals_pure_python(core, tmp_path, monkeypatch):
    bam_path = _workload_bam(tmp_path, 9, n_fragments=120,
                             contig_len=100_000, n_contigs=1)
    r1 = tbam.BamReader(bam_path)
    assert r1._payload_arr is not None, "native path not taken"
    b1 = r1.read_all()
    monkeypatch.setattr(native, "_lib", None)
    r2 = tbam.BamReader(bam_path)
    assert r2._payload_arr is None
    b2 = r2.read_all()
    assert b1.n == b2.n > 0
    assert all(b1.record_bytes(i) == b2.record_bytes(i) for i in range(b1.n))
    for k in ("tid", "pos", "l_qseq", "flag"):
        assert (getattr(b1, k) == getattr(b2, k)).all()


def test_mi_flags_matches_numpy_predicate(core):
    rng = np.random.default_rng(17)
    n = 3000
    parts, aux_off, end = [], np.zeros(n, np.int64), np.zeros(n, np.int64)
    p = 0
    for i in range(n):
        body = rng.integers(0, 256, int(rng.integers(36, 80)), dtype=np.uint8)
        if rng.random() < 0.25:
            k = int(rng.integers(0, len(body) - 4))
            body[k:k + 3] = [ord("M"), ord("I"), ord("Z")]
        aux_off[i] = p + 8
        end[i] = p + len(body)
        parts.append(body)
        p += len(body)
    d = np.concatenate(parts)
    f = core.mi_flags(d, aux_off, end)
    ref = np.zeros(n, dtype=np.uint8)
    cand = np.nonzero(d[:-3] == ord("M"))[0]
    for q in cand[(d[cand + 1] == ord("I")) & (d[cand + 2] == ord("Z"))]:
        i = int(np.searchsorted(end, q, side="right"))
        if i < n and aux_off[i] <= q and q + 3 < end[i]:
            ref[i] = 1
    assert (f == ref).all() and ref.sum() > 100
    jc = _jax_core()
    if jc is not None:
        assert (jc.mi_flags(d, aux_off, end) == f).all()


def test_nib_seen_matches_numpy_scan(core):
    rng = np.random.default_rng(23)
    n, pw = 500, 40
    packed = rng.integers(0, 256, (n, pw), dtype=np.uint8)
    lens = rng.integers(0, 2 * pw + 1, n).astype(np.int32)
    got = core.nib_seen(packed, lens)
    s256 = np.zeros(256, dtype=bool)
    s16 = np.zeros(16, dtype=bool)
    for i in range(n):
        nb = int(lens[i]) // 2
        s256[packed[i, :nb]] = True
        if lens[i] % 2:
            s16[packed[i, nb] >> 4] = True
    assert (got[0].astype(bool) == s256).all()
    assert (got[1].astype(bool) == s16).all()
    jc = _jax_core()
    if jc is not None:
        want = jc.nib_seen(packed, lens)
        assert (want[0] == got[0]).all() and (want[1] == got[1]).all()


_RACER = r"""
import sys
import numpy as np
from gencore_tpu_torch.io import native
native.BUILD_DIR = sys.argv[1]
lib = native.get_lib()
assert lib is not None, native.why_not()
payload = np.arange(100_000, dtype=np.uint32).view(np.uint8)
path = sys.argv[1] + "/rt_" + sys.argv[2] + ".bgzf"
assert native.bgzf_write(path, payload)
assert (native.bgzf_read(path) == payload).all()
print("LOADED", native.codec())
"""


def test_eight_processes_build_at_once_and_all_load(tmp_path):
    """Cold start under a parallel test run: every process finds an empty
    build directory, one compiles under the lock, all load a whole file."""
    build_dir = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("GENCORE_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, build_dir,
                               str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for i in range(8)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    codecs = {so.split()[-1] for so, _ in outs}
    assert len(codecs) == 1 and codecs <= set(CODECS), codecs
    left = sorted(os.listdir(build_dir))
    libs = [f for f in left if f.endswith(".so")]
    assert len(libs) == 1, left
    assert not [f for f in left if ".tmp" in f], left


def test_missing_compiler_is_reported_not_raised(tmp_path):
    """get_lib() keeps its contract without a compiler: None, with the
    reason in why_not(), and GENCORE_NO_NATIVE still forces None."""
    code = ("import sys\n"
            "from gencore_tpu_torch.io import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "assert native.get_lib() is None and native.codec() is None\n"
            "print('WHY', native.why_not())\n")
    for extra, want in (({"CXX": "false"}, "failed for codec"),
                        ({"GENCORE_NO_NATIVE": "1"}, "GENCORE_NO_NATIVE")):
        cp = subprocess.run(
            [sys.executable, "-c", code, str(tmp_path / "b")],
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=REPO, **extra))
        assert cp.returncode == 0, cp.stderr[-2000:]
        assert want in cp.stdout, cp.stdout


def test_a_refused_build_is_recorded_and_not_tried_again(tmp_path):
    """Where the first codec cannot be compiled (no libdeflate.h), the
    first process records the refusal; later ones go straight to zlib
    without starting the compiler for libdeflate again."""
    log = tmp_path / "calls.log"
    cxx = tmp_path / "cxx.sh"
    cxx.write_text('#!/bin/sh\n'
                   f'echo "$*" >> {log}\n'
                   'case "$*" in *GCIO_CODEC_LIBDEFLATE*)\n'
                   '  echo "fatal error: libdeflate.h: No such file" >&2\n'
                   '  exit 1;; esac\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    code = ("import sys\n"
            "from gencore_tpu_torch.io import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "assert native.get_lib() is not None, native.why_not()\n"
            "print('CODEC', native.codec())\n"
            "try:\n"
            "    native.build('libdeflate')\n"
            "except native.NativeCoreError as e:\n"
            "    print('REFUSED', e)\n")
    env = dict(os.environ, PYTHONPATH=REPO, CXX=str(cxx))
    env.pop("GENCORE_NO_NATIVE", None)
    for _ in range(3):
        cp = subprocess.run([sys.executable, "-c", code, str(tmp_path / "b")],
                            capture_output=True, text=True, timeout=240,
                            env=env)
        assert cp.returncode == 0, cp.stderr[-2000:]
        assert "CODEC zlib" in cp.stdout
        assert "REFUSED" in cp.stdout and "libdeflate.h" in cp.stdout
    calls = log.read_text().splitlines()
    assert sum("GCIO_CODEC_LIBDEFLATE" in c for c in calls) == 1, calls
    assert sum("GCIO_CODEC_ZLIB" in c for c in calls) == 1, calls
    left = sorted(os.listdir(tmp_path / "b"))
    assert len([f for f in left if f.endswith(".failed")]) == 1, left
    assert not [f for f in left if ".tmp" in f], left


def test_unloadable_library_gives_way_to_the_next_codec(tmp_path):
    """A build directory carried over from another machine may hold a
    libdeflate build that cannot load here: the zlib build takes over."""
    code = ("import os, sys\n"
            "from gencore_tpu_torch.io import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "os.makedirs(native.BUILD_DIR)\n"
            "with open(native.library_path('libdeflate'), 'wb') as f:\n"
            "    f.write(b'not a shared object')\n"
            "assert native.get_lib() is not None, native.why_not()\n"
            "print('CODEC', native.codec())\n")
    cp = subprocess.run([sys.executable, "-c", code, str(tmp_path / "b")],
                        capture_output=True, text=True, timeout=120,
                        env=dict(os.environ, PYTHONPATH=REPO))
    assert cp.returncode == 0, cp.stderr[-2000:]
    assert "CODEC zlib" in cp.stdout
