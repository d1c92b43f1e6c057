"""The port's engine on the CPU (plain twins of every device program)
against the scalar oracle and against the JAX engine on its Pallas path
(GENCORE_FORCE_PALLAS=interp, as tests/test_engine_pallas.py runs it):
records byte-equal and stats equal. Each side reads the same files with
its own package's reader, options and reference (the port keeps its own
copies of those modules)."""

import numpy as np
import pytest
import torch

from gencore_tpu.core.oracle import OracleEngine
from gencore_tpu.engine import VectorEngine as JaxEngine
from gencore_tpu.io import bam
from gencore_tpu.io.fasta import FastaRef
from gencore_tpu.options import Options
from gencore_tpu_torch.core import vote
from gencore_tpu_torch.engine import VectorEngine
from gencore_tpu_torch.io import bam as tbam
from gencore_tpu_torch.io.fasta import FastaRef as TFastaRef
from gencore_tpu_torch.options import Options as TOptions
from gencore_tpu_torch.tools import workloads
from gencore_tpu_torch.tools.workloads import SyntheticBam as TSyntheticBam
from tests.datagen import SyntheticBam
from tests.test_engine_equivalence import (STAT_FIELDS, _enc_list,
                                           assert_equivalent,
                                           make_random_workload)

torch.set_num_threads(1)


def run_three(sb, tmp_path, monkeypatch, opt_kwargs=None, use_fasta=True,
              jax_pallas=True):
    """(oracle, JAX engine, port on CPU) over one workload; asserts the
    port equals both. The JAX engine takes its Pallas path (interpret
    mode) unless jax_pallas is False: then its default route on the CPU
    (the XLA vote, fused_vote_kernel), for piles too deep for the
    interpreter."""
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    reader = bam.BamReader(bam_path)
    treader = tbam.BamReader(bam_path)
    ref = tref = None
    if use_fasta:
        fa = str(tmp_path / "ref.fa")
        sb.write_fasta(fa)
        ref = FastaRef.load(fa)
        tref = TFastaRef.load(fa)
    kw = opt_kwargs or {}
    oeng = OracleEngine(Options(**kw), reader.header, fasta=ref)
    oout = oeng.run(reader.read_all())
    if jax_pallas:
        monkeypatch.setenv("GENCORE_FORCE_PALLAS", "interp")
    jeng = JaxEngine(Options(**kw), reader.header, fasta=ref)
    jout = jeng.run(reader.read_all())
    monkeypatch.delenv("GENCORE_FORCE_PALLAS", raising=False)
    teng = VectorEngine(TOptions(**kw), treader.header, fasta=tref,
                        device="cpu")
    tout = teng.run(treader.read_all())
    assert_equivalent((oeng, oout), (teng, tout))
    assert _enc_list(tout) == _enc_list(jout)
    for f in STAT_FIELDS:
        assert getattr(teng.pre_stats, f) == getattr(jeng.pre_stats, f), f
        assert getattr(teng.post_stats, f) == getattr(jeng.post_stats, f), f
    return teng


def _refbase_reads(monkeypatch):
    """Counts, over a port run, the engine's gathered votes
    (vote.pallas_vote_gathered, and vote.pallas_vote for lenDiff-shifted
    jobs, "shifted_...") by how they get their refbase rows: ready-made
    ("rows": a gather of refbase rows on the host or the device, or a
    standalone assembly) or named by index in the window's refbase
    sources ("sources")."""
    seen = {"rows": 0, "sources": 0, "shifted_rows": 0, "shifted_sources": 0}
    orig_g = vote.pallas_vote_gathered
    orig_s = vote.pallas_vote

    def gathered(*a, refsrc=None, **k):
        seen["rows" if refsrc is None else "sources"] += 1
        return orig_g(*a, refsrc=refsrc, **k)

    def shifted(*a, refsrc=None, **k):
        seen["shifted_rows" if refsrc is None else "shifted_sources"] += 1
        return orig_s(*a, refsrc=refsrc, **k)

    monkeypatch.setattr(vote, "pallas_vote_gathered", gathered)
    monkeypatch.setattr(vote, "pallas_vote", shifted)
    return seen


@pytest.mark.parametrize("seed,umi_mode", [(1, "none"), (4, "single"),
                                           (6, "duplex")])
def test_port_engine_random_workloads(tmp_path, monkeypatch, seed, umi_mode):
    run_three(make_random_workload(seed, n_fragments=80, umi_mode=umi_mode),
              tmp_path, monkeypatch)


def test_port_engine_no_fasta(tmp_path, monkeypatch):
    """No reference: refbase rows are host-built and every bucket takes
    the gathered path."""
    run_three(make_random_workload(9, n_fragments=60), tmp_path, monkeypatch,
              use_fasta=False)


def test_port_engine_duplex(tmp_path, monkeypatch):
    sb = make_random_workload(90, n_fragments=60, umi_mode="duplex",
                              contig_len=300_000, n_contigs=1)
    run_three(sb, tmp_path, monkeypatch)


def test_port_engine_raw_quals(tmp_path, monkeypatch):
    """>15 distinct qual values: raw qual uploads, no nibble qual table."""
    sb = SyntheticBam(seed=93, contig_len=200_000)
    rng = np.random.default_rng(94)
    for k in range(40):
        pos = 1000 + 400 * k
        for _ in range(int(rng.integers(1, 4))):
            qual = rng.integers(5, 41, size=100).astype(np.uint8)
            seq1, cg1 = sb.read_seq(0, pos, 100,
                                    n_errors=int(rng.random() < 0.4))
            seq2, cg2 = sb.read_seq(0, pos + 150, 100)
            qname = sb._qname("ACGT_TTAA")
            sb._add(0, pos, qname, 99, cg1, 0, pos + 150, 250, seq1, qual, 0)
            sb._add(0, pos + 150, qname, 147, cg2, 0, pos, -250, seq2,
                    rng.integers(5, 41, size=100).astype(np.uint8), 0)
    run_three(sb, tmp_path, monkeypatch)


def test_port_engine_sparse_overflow(tmp_path, monkeypatch):
    """More seq edits than the sparse cap: the dense overflow pull."""
    sb = SyntheticBam(seed=95, contig_len=200_000)
    for k in range(20):
        pos = 1000 + 500 * k
        for d in range(4):
            sb.add_pair(0, pos, pos + 150, read_len=100, umi="AACC_GGTT",
                        n_errors=14 if d == 0 else 0,
                        qual=15 if d == 0 else 36)
    run_three(sb, tmp_path, monkeypatch)


def test_port_engine_shifted_members(tmp_path, monkeypatch):
    """Right-mode jobs with lenDiff shifts: host re-gather + the
    pre-gathered vote whose rows override the bucket's; both read their
    refbase rows by index in the window's sources (no refbase gather, no
    standalone assembly)."""
    seen = _refbase_reads(monkeypatch)
    sb = SyntheticBam(seed=91, contig_len=100_000)
    for k in range(10):
        pos1 = 1000 + 400 * k
        end2 = pos1 + 240
        sb.add_pair(0, pos1, end2 - 100, read_len=100)
        qname = sb._qname(None)
        seq1, cg1 = sb.read_seq(0, pos1, 100)
        seq2, cg2 = sb.read_seq(0, end2 - 80, 80)
        sb._add(0, pos1, qname, 99, cg1, 0, end2 - 80, 240, seq1, 35, 0)
        sb._add(0, end2 - 80, qname, 147, cg2, 0, pos1, -240, seq2, 35, 0)
    run_three(sb, tmp_path, monkeypatch)
    assert seen["shifted_sources"] > 0 and seen["sources"] > 0
    assert seen["rows"] == seen["shifted_rows"] == 0


@pytest.mark.parametrize("case", ["plain", "no_fasta", "duplex", "shifted"])
def test_port_engine_full_bins_data(tmp_path, monkeypatch, case):
    """Reads with nt16 codes outside =ACGTN take the full-bins vote
    (fused_vote_kernel, all 16 bins, shifts applied on the device): the
    port equals the oracle and the JAX engine (whose non-Pallas route it
    follows)."""
    umi_mode = {"plain": "single", "no_fasta": "single", "duplex": "duplex",
                "shifted": "none"}[case]
    sb = workloads.full_bins_bam(70 + len(case), 24, umi_mode=umi_mode,
                                 shifted=case in ("shifted", "duplex"))
    teng = run_three(sb, tmp_path, monkeypatch,
                     use_fasta=case != "no_fasta")


def test_port_engine_deep_pile(tmp_path, monkeypatch):
    """The ultra-deep recipe cut to 2 loci x 260 pairs, with UMI grouping
    off (the reads carry UMIs in their names, which the default `auto`
    would use): each pile is one job of 260 members per side, above the
    window path's 255, so the gathered vote takes it (one bucket,
    K = 512), reading each job's refbase row where it lies (the window's
    sources: no refbase gather, no standalone assembly). The JAX engine
    takes its XLA route here: Pallas interpret mode needs minutes for a
    bucket that deep."""
    seen = _refbase_reads(monkeypatch)
    calls = []
    orig = vote.vote_gathered_plain

    def counted(*a, **k):
        calls.append(tuple(a[3].shape))
        return orig(*a, **k)

    monkeypatch.setattr(vote, "vote_gathered_plain", counted)
    run_three(workloads.ultradeep_bam(n_loci=2, pairs=260,
                                      contig_len=250_000),
              tmp_path, monkeypatch, opt_kwargs={"umi_prefix": ""},
              jax_pallas=False)
    assert (512, 4) in calls
    assert seen["sources"] > 0
    assert seen["rows"] == seen["shifted_rows"] == 0


def test_port_engine_window_past_u16_rows(tmp_path, monkeypatch):
    """One window of 66,400 sparse rows (830 loci x 40 overlapping pairs
    of 40-base reads), more than a u16 mate row can name: the port takes
    the deferred upload-and-score program with u32 mate rows (where the
    JAX engine takes its non-deferred upload and int32 score map), never
    the plain standalone upload, and its records equal the oracle's and
    the JAX engine's (its XLA route on the CPU)."""
    from gencore_tpu_torch import engine as teng_mod
    rng = np.random.default_rng(5)
    sb = SyntheticBam(seed=5, contig_len=2_000_000)
    for k in range(830):
        pos = 1000 + 600 * k
        for _ in range(40):
            sb.add_pair(0, pos, pos + int(rng.integers(10, 30)), read_len=40,
                        umi="AACC_GGTT", n_errors=int(rng.random() < 0.3),
                        qual=int(rng.choice([18, 30, 36])))
    deferred, standalone = [], []
    orig_fn = teng_mod._upload_score_fn
    orig_up = teng_mod._WorkArrays.upload

    def fn(*static):
        deferred.append(static)
        return orig_fn(*static)

    def up(self, *a, **k):
        standalone.append(self.upload_mode)
        return orig_up(self, *a, **k)

    monkeypatch.setattr(teng_mod, "_upload_score_fn", fn)
    monkeypatch.setattr(teng_mod._WorkArrays, "upload", up)
    teng = run_three(sb, tmp_path, monkeypatch, jax_pallas=False)
    assert teng.work.upload_mode == "sparse" and teng.work.n_pad > 1 << 16
    assert len(deferred) == 1 and deferred[0][-1] is True    # mate32
    assert deferred[0][-2] is False                          # overlaps
    assert standalone == []


def test_port_engine_long_reads(tmp_path, monkeypatch):
    """~300 pairs of 300-base reads (workloads.long_amplicon_bam cut to 4
    amplicons x 30 molecules, mates overlapping by 40-200 bases): reads
    past 256 bases stage dense, so the port unpacks and scores through
    the dense route (on the CPU the twins of csrc/upload_dense.cu, the
    int32 score map at w = 304) and votes at L = 320, each job's refbase
    row read where it lies (no refbase gather, no standalone assembly);
    records equal to the oracle's and to the JAX engine's on its Pallas
    path."""
    seen = _refbase_reads(monkeypatch)
    from gencore_tpu_torch import engine as teng_mod
    from gencore_tpu_torch.core import kernels as tk
    calls = []
    for mod, name in ((teng_mod, "_upload_unpack_plain"),
                      (tk, "score_map_plain")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append((_n, a[:2] if _n[0] == "_" else a[0].shape)),
            _o(*a, **k))[1])
    teng = run_three(workloads.long_amplicon_bam(
        n_amplicons=4, molecules=30, contig_len=60_000), tmp_path, monkeypatch)
    assert teng.work.upload_mode == "dense" and teng.work.L == 320
    assert ("_upload_unpack_plain", (304, 320)) in calls
    assert any(n == "score_map_plain" and shape[1] == 320
               for n, shape in calls)
    assert seen["sources"] > 0
    assert seen["rows"] == seen["shifted_rows"] == 0


def test_port_engine_default_device_needs_cuda():
    """The default device is CUDA; without one the engine raises rather
    than running on the CPU."""
    sb = TSyntheticBam(seed=1, contig_len=10_000)
    if torch.cuda.is_available():
        assert VectorEngine(TOptions(), sb.header).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VectorEngine(TOptions(), sb.header)


@pytest.mark.parametrize("switch", ["GENCORE_NO_SPARSE_UP", "GENCORE_NO_SPARSE",
                                    "GENCORE_NO_CONTIG_VOTE",
                                    "GENCORE_NO_DEVREF", "GENCORE_NO_QPACK"])
def test_port_engine_off_main_branches(tmp_path, monkeypatch, switch):
    """The engine's other device branches (dense upload, dense/packed
    collect, per-bucket votes, host refbase, raw qual download) against
    the oracle."""
    sb = make_random_workload(6, n_fragments=60, umi_mode="duplex")
    sb.write_bam(str(tmp_path / "in.bam"))
    sb.write_fasta(str(tmp_path / "ref.fa"))
    reader = bam.BamReader(str(tmp_path / "in.bam"))
    ref = FastaRef.load(str(tmp_path / "ref.fa"))
    oeng = OracleEngine(Options(), reader.header, fasta=ref)
    oout = oeng.run(reader.read_all())
    monkeypatch.setenv(switch, "1")
    treader = tbam.BamReader(str(tmp_path / "in.bam"))
    teng = VectorEngine(TOptions(), treader.header,
                        fasta=TFastaRef.load(str(tmp_path / "ref.fa")),
                        device="cpu")
    tout = teng.run(treader.read_all())
    assert_equivalent((oeng, oout), (teng, tout))
