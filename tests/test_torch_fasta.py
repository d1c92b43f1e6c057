"""The port's reference load (`gencore_tpu_torch/io/fasta.py`, the native
core's two FASTA passes in `csrc/gcio.cpp`, and the genome the engine
builds and sends up, `engine._upload_genome`): the native loader and the
Python fallback held to the JAX package's loader on crafted FASTAs, one
genome buffer reused by `genome.build` where the BAM header allows, the
chunked NT16 upload held to the one-shot coding it replaced, and the
memory the load holds."""

import tracemalloc

import numpy as np
import pytest
import torch

from gencore_tpu.io.fasta import FastaRef as JaxFastaRef
from gencore_tpu_torch import engine
from gencore_tpu_torch.engine import VectorEngine
from gencore_tpu_torch.io import bam as bamio
from gencore_tpu_torch.io import native
from gencore_tpu_torch.io.fasta import FastaRef
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.utils import tracing

CHUNK = 1 << 20      # the native passes' read size (kFastaChunk in gcio.cpp)


def _long_lines() -> bytes:
    """Lines longer than a chunk, and headers, CRLFs and line ends on
    either side of each chunk boundary."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGTNacgtnRYkm-*", dtype=np.uint8)
    out = [b">one line\n", bases[rng.integers(0, 16, CHUNK + CHUNK // 2)]
           .tobytes(), b"\n"]
    for k, shift in enumerate((-2, -1, 0, 1, 2)):
        # the next header's '>' lands `shift` bytes past a chunk boundary
        at = sum(map(len, out))
        boundary = (at // CHUNK + 1) * CHUNK
        fill = boundary + shift - at - 2
        out += [b"A" * max(fill, 0), b"\r\n", f">h{k} x\r\n".encode(),
                b"acgt" * 20, b"\n"]
    return b"".join(out)


CASES = {
    "bases": (b">c1\nacgtNNnn-*xy\nRYKMSWBDHVU\nAC1G2 T\tA\n"
              b">c2\nUUUU0123..ac\n"),
    "crlf_no_final_newline": b">a\r\nACGT\r\nacgt\r\n>b b\r\nTT\r\r\nG",
    "headers": (b"ACGTACGT\nNN\n>with spaces in it\nAC\n>tab\tx y\nGG\n"
                b">\nTT\n> lead\nCC\n>\r\nAA\n"),
    "empty_and_repeated": (b">e1\n>r\nAAAA\n>e2\n\n\n>r\nCC\n>s\nG\n"
                           b">r\nTTT\n>t\n"),
    "long_lines": _long_lines(),
}


@pytest.mark.parametrize("max_contig", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("loader", ["native", "python"])
def test_loader_matches_the_jax_loader(tmp_path, monkeypatch, loader, case,
                                       max_contig):
    path = tmp_path / "ref.fa"
    path.write_bytes(CASES[case])
    want = JaxFastaRef.load(str(path), max_contig)
    if loader == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, native.why_not()
    got = FastaRef.load(str(path), max_contig)
    assert got.load_info["native"] == (loader == "native")
    assert list(got.contigs) == list(want.contigs)
    for name, seq in want.contigs.items():
        assert got.contigs[name].dtype == np.uint8
        assert got.contigs[name].tobytes() == seq.tobytes(), name
        assert got.contig_len(name) == len(seq)
    # one buffer: every contig a view of it, back to back in dict order
    assert got.genome.tobytes() == b"".join(
        s.tobytes() for s in want.contigs.values())
    for name, seq in got.contigs.items():
        assert seq.base is got.genome or not len(seq)
        assert got.offset[name] + len(seq) <= len(got.genome)
    assert got.load_info["contigs"] == len(want.contigs)
    # the native loader reads the file twice; Python's loop stops at the
    # header past max_contig
    size, read = path.stat().st_size, got.load_info["bytes_read"]
    if loader == "native":
        assert read == 2 * size
    else:
        assert read == size or (max_contig and read < size)


def _fasta(tmp_path, contigs: dict):
    path = tmp_path / "g.fa"
    path.write_bytes(b"".join(b">" + n.encode() + b"\n" + s + b"\n"
                              for n, s in contigs.items()))
    return FastaRef.load(str(path))


def _engine(ref, names):
    header = bamio.BamHeader(names=list(names),
                             lengths=[ref.contig_len(n) or 1 for n in names])
    return VectorEngine(Options(), header, fasta=ref, device="cpu")


def _build_span(spans):
    (build,) = [s for s in spans if s.name == "genome.build"]
    return build.attrs


@pytest.mark.parametrize("names,reused", [
    (["c1", "c2", "c3"], True),          # the FASTA's order
    (["c1", "c2"], True),                # a prefix of it
    (["c1", "zz", "c2", "c3"], True),    # a name the FASTA lacks adds none
    (["c2", "c1", "c3"], False),         # reordered
    (["c1", "c3"], False),               # missing a contig between two
    (["c1", "c2", "c1"], False),         # a contig twice
])
def test_genome_build_reuses_the_fasta_buffer(tmp_path, names, reused):
    rng = np.random.default_rng(3)
    seqs = {f"c{i}": np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n)].tobytes()
        for i, n in ((1, 700), (2, 90), (3, 1234))}
    ref = _fasta(tmp_path, seqs)
    with tracing.recording():
        eng = _engine(ref, names)
    attrs = _build_span(tracing.take())
    # what the old build made: the header's contigs concatenated
    old = np.concatenate([np.frombuffer(seqs[n], np.uint8) if n in seqs
                          else np.zeros(0, np.uint8) for n in names])
    assert eng._genome.tobytes() == old.tobytes()
    assert np.shares_memory(eng._genome, ref.genome) == reused
    assert (attrs["copied_MB"] == 0) == reused
    if not reused:
        assert attrs["copied_MB"] == pytest.approx(len(old) / 1e6)
    lens = [len(seqs.get(n, b"")) for n in names]
    assert eng._contig_len.tolist() == lens
    assert eng._contig_base.tolist() == [0, *np.cumsum(lens).tolist()]
    # the window engines of one run share the one genome
    assert _engine(ref, names)._genome is eng._genome


def test_genome_upload_in_chunks_equals_the_one_shot_coding(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(engine, "_GENOME_CHUNK", 1000)
    every_byte = np.arange(256, dtype=np.uint8)
    g = np.tile(every_byte, 20)[:4_321]
    want = np.pad(engine._ASCII_TO_NT16[g], (0, engine._GENOME_PAD))
    for lib in (native.get_lib, lambda: None):   # native coding, numpy's
        monkeypatch.setattr(native, "get_lib", lib)
        with tracing.recording(), tracing.span("genome.upload"):
            dev = engine._upload_genome(g, torch.device("cpu"))
        (span,) = tracing.take()
        assert span.attrs == {"chunks": 5, "pinned": 0}
        assert dev.dtype == torch.uint8 and dev.numpy().tobytes() == \
            want.tobytes()
    assert engine._upload_genome(g[:0], torch.device("cpu")).tolist() == \
        [0] * engine._GENOME_PAD
    # through the engine: the FASTA's genome, cached per device
    rng = np.random.default_rng(5)
    seqs = {"a": np.frombuffer(b"ACGTNacgt", np.uint8)[
        rng.integers(0, 9, 2_500)].tobytes(), "b": b"GATTACA" * 300}
    eng = _engine(_fasta(tmp_path, seqs), ["a", "b"])
    dev = eng._genome_dev()
    assert dev.numpy().tobytes() == np.pad(
        engine._ASCII_TO_NT16[eng._genome],
        (0, engine._GENOME_PAD)).tobytes()
    assert eng._genome_dev() is dev


def test_load_build_and_staging_hold_one_genome(tmp_path, monkeypatch):
    chunk = 1 << 18
    monkeypatch.setattr(engine, "_GENOME_CHUNK", chunk)
    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGTacgtN", np.uint8)
    path = tmp_path / "big.fa"
    with open(path, "wb") as f:
        for name, n in (("chr1", 2_400_000), ("chr2", 1_700_000)):
            seq = bases[rng.integers(0, 9, n)].tobytes()
            f.write(f">{name} some description\n".encode())
            f.write(b"\n".join(seq[i:i + 70] for i in range(0, n, 70)))
            f.write(b"\n")
    genome_bytes = 4_100_000
    native.get_lib()
    tracemalloc.start()
    try:
        ref = FastaRef.load(str(path))
        eng = _engine(ref, ["chr1", "chr2"])
        eng._genome_dev()
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert len(ref.genome) == genome_bytes
    assert np.shares_memory(eng._genome, ref.genome)
    assert peak < 1.25 * genome_bytes + 2 * chunk, peak


def test_second_pass_refuses_a_file_that_changed(tmp_path):
    path = tmp_path / "ref.fa"
    path.write_bytes(b">a\nACGT\n>b\nGG\n")
    kept, headers, size = native.fasta_scan(str(path))
    assert kept.tolist() == [0, 4, 2] and headers == [b"", b"a", b"b"]
    out = np.zeros(6, np.uint8)
    dest = np.array([-1, 0, 4])
    assert native.fasta_fill(str(path), dest, kept, out) == size
    assert out.tobytes() == b"ACGTGG"
    for changed in (b">a\nACGTA\n>b\nGG\n", b">a\nACGT\n>b\nGG\n>c\n",
                    b">a\nACGT\n"):
        path.write_bytes(changed)
        with pytest.raises(OSError, match="changed while it was read"):
            native.fasta_fill(str(path), dest, kept, out)
    with pytest.raises(FileNotFoundError):
        FastaRef.load(str(tmp_path / "missing.fa"))
