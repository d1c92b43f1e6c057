"""The port's bounded-memory streaming path (parallel/streaming.py on the
port's own native core) on the CPU: the five cases of tests/test_streaming.py
for the port, with the records and stats of each run held to the JAX
package's run on the same input. Records are compared after BGZF
inflation (record bytes), never as compressed bytes. Tolerance 0."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from gencore_tpu.io import bam as jbam
from gencore_tpu.io import native as jax_native
from gencore_tpu.io.fasta import FastaRef as JFastaRef
from gencore_tpu.options import Options as JOptions
from gencore_tpu.parallel import pipeline as jpipe
from gencore_tpu.parallel import streaming as jstreaming
from gencore_tpu_torch.io import bam as tbam
from gencore_tpu_torch.io import native
from gencore_tpu_torch.io.fasta import FastaRef
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.parallel import pipeline as pipe
from gencore_tpu_torch.parallel import streaming
from tests.test_engine_equivalence import STAT_FIELDS, make_random_workload

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(path):
    b = tbam.BamReader(path).read_all()
    return [b.record_bytes(i) for i in range(b.n)]


def _inputs(tmp_path, seed, **kw):
    sb = make_random_workload(seed, **kw)
    bam_path, fa = str(tmp_path / "in.bam"), str(tmp_path / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa)
    return bam_path, fa


def _jax_run(tmp_path, bam_path, fa, n_windows):
    """The JAX package's records and stats for the same input: through its
    run_streaming where its native core loaded, else through its in-memory
    window pipeline (the two are byte-identical by its own tests)."""
    ref = JFastaRef.load(fa)
    out = str(tmp_path / "jax.bam")
    if jax_native.get_lib() is not None:
        _, pre, post = jstreaming.run_streaming(JOptions(), bam_path, out,
                                                fasta=ref, n_windows=n_windows)
    else:
        rdr = jbam.BamReader(bam_path)
        tables, pre, post = jpipe.run_pipelined(
            JOptions(), rdr.read_all(), rdr.header, fasta=ref,
            n_windows=n_windows)
        w = jbam.BamWriter(out, rdr.header)
        w.write_payload(jpipe.merged_payload(tables))
        w.close()
    return _records(out), pre, post


def _same_stats(a, b, tag):
    for f in STAT_FIELDS:
        assert getattr(a, f) == getattr(b, f), (tag, f)


def test_block_table_and_ranged_decode(tmp_path):
    """StreamingBam's index over ranged decodes equals the whole-file
    reader, chunk by chunk and window by window."""
    bam_path, _ = _inputs(tmp_path, 90, n_fragments=150, umi_mode="plain",
                          contig_len=300_000, n_contigs=2)
    whole = tbam.BamReader(bam_path).read_all()
    sbam = streaming.StreamingBam(bam_path, chunk_bytes=1 << 13)
    index = sbam.build_index()
    assert index.n == whole.n > 0
    for k in ("tid", "pos", "mtid", "mpos", "isize", "flag", "l_qseq"):
        assert (getattr(index, k) == getattr(whole, k)).all(), k
    idx = np.arange(whole.n // 3, 2 * whole.n // 3)
    part = sbam.window_batch(index, idx)
    assert part.n == len(idx)
    assert all(part.record_bytes(i) == whole.record_bytes(int(j))
               for i, j in enumerate(idx))


def test_incremental_bgzf_writer(tmp_path):
    """StreamingBamWriter's window-by-window file decodes to the same
    records as one BamWriter call."""
    bam_path, _ = _inputs(tmp_path, 92, n_fragments=120, umi_mode="plain",
                          contig_len=200_000, n_contigs=1)
    rdr = tbam.BamReader(bam_path)
    batch = rdr.read_all()
    bodies = [batch.record_bytes(i) for i in range(batch.n)]
    payload = np.frombuffer(b"".join(
        len(b).to_bytes(4, "little") + b for b in bodies), dtype=np.uint8)
    cut = len(b"".join(len(b).to_bytes(4, "little") + b
                       for b in bodies[:batch.n // 2]))
    w = streaming.StreamingBamWriter(str(tmp_path / "inc.bam"), rdr.header)
    w.write_payload(payload[:cut])
    w.write_payload(payload[cut:])
    w.close()
    one = tbam.BamWriter(str(tmp_path / "one.bam"), rdr.header)
    one.write_payload(payload)
    one.close()
    assert _records(str(tmp_path / "inc.bam")) == bodies
    assert _records(str(tmp_path / "one.bam")) == bodies
    assert jbam.BamReader(str(tmp_path / "inc.bam")).read_all().n == batch.n


@pytest.mark.parametrize("chunk_bytes", [1 << 14, 64 << 20])
def test_streaming_matches_pipeline(tmp_path, chunk_bytes):
    bam_path, fa = _inputs(tmp_path, 91, n_fragments=250, umi_mode="duplex",
                           contig_len=500_000, n_contigs=2)
    ref = FastaRef.load(fa)
    rdr = tbam.BamReader(bam_path)
    tables, pre_m, post_m = pipe.run_pipelined(
        Options(), rdr.read_all(), rdr.header, fasta=ref, n_windows=4,
        device="cpu")
    mem_out = str(tmp_path / "mem.bam")
    w = tbam.BamWriter(mem_out, rdr.header)
    w.write_payload(pipe.merged_payload(tables))
    w.close()

    stream_out = str(tmp_path / "stream.bam")
    _, pre_s, post_s = streaming.run_streaming(
        Options(), bam_path, stream_out, fasta=ref, n_windows=4,
        chunk_bytes=chunk_bytes, device="cpu")
    got = _records(stream_out)
    assert got == _records(mem_out) and len(got) > 100
    _same_stats(pre_m, pre_s, "pre")
    _same_stats(post_m, post_s, "post")

    want, pre_j, post_j = _jax_run(tmp_path, bam_path, fa, 4)
    assert got == want
    _same_stats(pre_j, pre_s, "pre vs jax")
    _same_stats(post_j, post_s, "post vs jax")


def test_streaming_with_the_zlib_core_equals_the_default(tmp_path,
                                                         monkeypatch):
    """The codec changes compressed bytes only: a run on the zlib build of
    the core writes the same records as the default build."""
    bam_path, fa = _inputs(tmp_path, 93, n_fragments=120, umi_mode="single",
                           contig_len=300_000, n_contigs=2)
    ref = FastaRef.load(fa)
    outs = {}
    for codec in ("default", "zlib"):
        if codec == "zlib":
            monkeypatch.setattr(native, "_lib", native.load("zlib"))
            monkeypatch.setattr(native, "_tried", True)
            assert native.codec() == "zlib"
        out = str(tmp_path / f"{codec}.bam")
        _, _, post = streaming.run_streaming(Options(), bam_path, out,
                                             fasta=ref, n_windows=3,
                                             device="cpu")
        outs[codec] = (_records(out), post.sscs_num, post.dcs_num)
    assert outs["zlib"] == outs["default"] and len(outs["zlib"][0]) > 50


def test_streaming_mid_run_error_raises_not_hangs(tmp_path, monkeypatch):
    """A decode error mid-stream surfaces as an exception; the 3-thread
    runner (decoder/dispatch/collector) does not deadlock on it."""
    bam_path, _ = _inputs(tmp_path, 52, n_fragments=300, contig_len=500_000,
                          n_contigs=2)
    orig = streaming.StreamingBam.window_batch
    calls = {"n": 0}

    def boom(self, index, idx):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise IOError("synthetic mid-stream decode failure")
        return orig(self, index, idx)

    monkeypatch.setattr(streaming.StreamingBam, "window_batch", boom)
    result = {}

    def run():
        try:
            streaming.run_streaming(Options(), bam_path,
                                    str(tmp_path / "out.bam"), n_windows=4,
                                    device="cpu")
            result["outcome"] = "returned"
        except IOError as e:
            result["outcome"] = f"raised: {e}"
        except BaseException as e:  # noqa: BLE001
            result["outcome"] = f"raised-other: {type(e).__name__}"

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "run_streaming hung on a mid-stream error"
    assert result["outcome"].startswith("raised: synthetic"), result


def test_piped_stdin_stdout_streams(tmp_path):
    """`-i - -o -` takes the streaming path (GENCORE_STREAM_THRESHOLD=1)
    and says so; its bytes equal the file->file streaming run's (one
    process image, one codec), and its records the JAX package's."""
    bam_path, fa = _inputs(tmp_path, 61, n_fragments=400, contig_len=400_000,
                           n_contigs=2)
    env = {**os.environ, "GENCORE_STREAM_THRESHOLD": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("GENCORE_NO_NATIVE", None)
    out_file = str(tmp_path / "out_file.bam")
    base = [sys.executable, "-m", "gencore_tpu_torch.cli", "-r", fa,
            "--debug", "--device", "cpu"]
    pf = subprocess.run(
        base + ["-i", bam_path, "-o", out_file,
                "-j", str(tmp_path / "f.json"), "-h", str(tmp_path / "f.html")],
        capture_output=True, timeout=600, env=env, cwd=str(tmp_path))
    assert pf.returncode == 0, pf.stderr.decode()[-800:]
    assert b"[stage] index" in pf.stderr
    io_lines = [ln for ln in pf.stderr.decode().splitlines()
                if ln.startswith("I/O: ")]
    assert io_lines == [f"I/O: native core ({native.codec()}), "
                        "streaming path"], io_lines
    with open(bam_path, "rb") as fin:
        pp = subprocess.run(
            base + ["-i", "-", "-o", "-",
                    "-j", str(tmp_path / "p.json"),
                    "-h", str(tmp_path / "p.html")],
            stdin=fin, capture_output=True, timeout=600, env=env,
            cwd=str(tmp_path))
    assert pp.returncode == 0, pp.stderr.decode()[-800:]
    assert b"streaming path" in pp.stderr
    with open(out_file, "rb") as f:
        assert pp.stdout == f.read(), "piped output != file->file output"
    want, _, _ = _jax_run(tmp_path, bam_path, fa, 0)
    assert _records(out_file) == want
