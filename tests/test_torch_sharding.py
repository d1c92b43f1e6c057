"""Coordinate sharding, checkpoint and resume of the port
(parallel/windows.run_sharded, parallel/resume) on the CPU: the cases of
tests/test_window_sharding.py for the port, each also held to the JAX
package's run_sharded on the same input; and checkpoint directories
carried across the two packages in both directions. Records, keys and
stats are integers and bytes: tolerance 0."""

import json
import os

import numpy as np
import pytest
import torch

from gencore_tpu.engine import VectorEngine as JEngine
from gencore_tpu.io import bam as jbam
from gencore_tpu.io.fasta import FastaRef as JFastaRef
from gencore_tpu.options import Options as JOptions
from gencore_tpu.parallel import resume as jresume
from gencore_tpu.parallel import windows as jwindows
from gencore_tpu_torch import cli as port_cli
from gencore_tpu_torch.engine import VectorEngine
from gencore_tpu_torch.io import bam
from gencore_tpu_torch.io.fasta import FastaRef
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.parallel import resume, windows
from tests.datagen import SyntheticBam
from tests.test_engine_equivalence import STAT_FIELDS, make_random_workload

torch.set_num_threads(1)


def _recs(tables):
    return sorted(b for t in tables for b in t.encoded_records())


def _same_stats(pre_a, post_a, pre_b, post_b):
    for f in STAT_FIELDS:
        assert getattr(pre_a, f) == getattr(pre_b, f), ("pre", f)
        assert getattr(post_a, f) == getattr(post_b, f), ("post", f)
    assert (pre_a.supporting_histogram == pre_b.supporting_histogram).all()
    for a, b in zip(pre_a.genome_depth, pre_b.genome_depth):
        assert (a == b).all()
    for a, b in zip(post_a.genome_depth, post_b.genome_depth):
        assert (a == b).all()


@pytest.fixture(scope="module")
def duplex_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    sb = make_random_workload(50, n_fragments=200, umi_mode="duplex",
                              contig_len=600_000, n_contigs=2)
    bam_path, fa = str(d / "in.bam"), str(d / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa)
    reader = bam.BamReader(bam_path)
    eng = VectorEngine(Options(), reader.header, fasta=FastaRef.load(fa),
                       device="cpu")
    single = eng.run(reader.read_all())
    return bam_path, fa, sorted(single.encoded_records()), eng


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_equals_single(duplex_inputs, n_shards):
    bam_path, fa, single_recs, eng = duplex_inputs
    reader = bam.BamReader(bam_path)
    tables, pre, post = windows.run_sharded(
        Options(), reader.read_all(), reader.header, fasta=FastaRef.load(fa),
        n_shards=n_shards, device="cpu")
    assert _recs(tables) == single_recs and len(single_recs) > 100
    _same_stats(eng.pre_stats, eng.post_stats, pre, post)
    merged = windows.merged_records(tables)
    assert sorted(merged) == single_recs

    jreader = jbam.BamReader(bam_path)
    jt, jpre, jpost = jwindows.run_sharded(
        JOptions(), jreader.read_all(), jreader.header,
        fasta=JFastaRef.load(fa), n_shards=n_shards)
    assert jwindows.merged_records(jt) == merged
    assert [t.record_keys().tolist() for t in jt] == \
        [t.record_keys().tolist() for t in tables]
    _same_stats(jpre, jpost, pre, post)


def test_sharded_tick_checkpoint(tmp_path):
    """Global checkpoint injection: >10000 clustered reads split over
    shards reproduce the single-run threshold behaviour."""
    sb = SyntheticBam(seed=51, contig_len=4_000_000)
    rng = np.random.default_rng(52)
    for k in range(5500):
        pos1 = 1000 + 600 * k
        sb.add_pair(0, pos1, pos1 + 150, umi=str(rng.choice(["AAAA", "AAAT"])))
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    reader = bam.BamReader(bam_path)
    eng = VectorEngine(Options(), reader.header, device="cpu")
    single = eng.run(bam.BamReader(bam_path).read_all())
    tables, pre, post = windows.run_sharded(Options(), reader.read_all(),
                                            reader.header, n_shards=3,
                                            device="cpu")
    assert sorted(single.encoded_records()) == _recs(tables)
    assert eng.post_stats.sscs_num == post.sscs_num

    jreader = jbam.BamReader(bam_path)
    jt, _, jpost = jwindows.run_sharded(JOptions(), jreader.read_all(),
                                        jreader.header, n_shards=3)
    assert _recs(jt) == _recs(tables)
    assert jpost.sscs_num == post.sscs_num


@pytest.fixture
def single_inputs(tmp_path):
    sb = make_random_workload(53, n_fragments=80, umi_mode="single",
                              contig_len=300_000, n_contigs=1)
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    return bam_path


def _port_run(bam_path, ckdir, opt=None):
    reader = bam.BamReader(bam_path)
    return windows.run_sharded(opt or Options(), reader.read_all(),
                               reader.header, n_shards=3,
                               checkpoint_dir=ckdir, device="cpu")


def _jax_run(bam_path, ckdir):
    reader = jbam.BamReader(bam_path)
    return jwindows.run_sharded(JOptions(), reader.read_all(), reader.header,
                                n_shards=3, checkpoint_dir=ckdir)


def test_checkpoint_resume(single_inputs, tmp_path):
    """Crash-resume: completed shards load from the manifest and the final
    result is identical; a shard whose files are gone is recomputed alone;
    changed options invalidate the checkpoint."""
    ckdir = str(tmp_path / "ck")
    t1, pre1, post1 = _port_run(single_inputs, ckdir)
    assert not any(isinstance(t, windows.LoadedShard) for t in t1)
    t2, pre2, post2 = _port_run(single_inputs, ckdir)
    assert all(isinstance(t, windows.LoadedShard) for t in t2)
    assert _recs(t1) == _recs(t2)
    _same_stats(pre1, post1, pre2, post2)

    for f in os.listdir(ckdir):
        if f.startswith("shard_1."):
            os.remove(os.path.join(ckdir, f))
    t3, pre3, post3 = _port_run(single_inputs, ckdir)
    assert [isinstance(t, windows.LoadedShard) for t in t3] == \
        [True, False, True]
    assert _recs(t3) == _recs(t1)
    _same_stats(pre1, post1, pre3, post3)
    assert sorted(os.listdir(ckdir)) == sorted(
        ["manifest.json"] + [f"shard_{s}.{ext}" for s in range(3)
                             for ext in ("payload", "keys.npy", "stats.pkl")])

    t4, _, _ = _port_run(single_inputs, str(tmp_path / "ck2"),
                         Options(cluster_size_req=2))
    assert not any(isinstance(t, windows.LoadedShard) for t in t4)
    t5, _, _ = _port_run(single_inputs, ckdir, Options(cluster_size_req=2))
    assert not any(isinstance(t, windows.LoadedShard) for t in t5)


def test_options_fingerprint_equals_the_jax_package():
    for kw in ({}, {"cluster_size_req": 2, "umi_prefix": "UMI"},
               {"duplex_only": True, "score_percent_req": 0.75}):
        assert (resume.options_fingerprint(Options(**kw))
                == jresume.options_fingerprint(JOptions(**kw)))


def test_jax_written_checkpoint_resumes_under_the_port(single_inputs,
                                                       tmp_path):
    ckdir = str(tmp_path / "ck")
    jt, jpre, jpost = _jax_run(single_inputs, ckdir)
    with open(os.path.join(ckdir, "manifest.json")) as f:
        assert json.load(f)["completed"] == [0, 1, 2]
    os.remove(os.path.join(ckdir, "shard_2.payload"))
    tables, pre, post = _port_run(single_inputs, ckdir)
    assert [isinstance(t, windows.LoadedShard) for t in tables] == \
        [True, True, False]
    assert _recs(tables) == _recs(jt)
    _same_stats(jpre, jpost, pre, post)
    # what the port loaded are its own Stats objects
    ck = resume.WindowCheckpoint(ckdir, Options(umi_prefix=""), 3)
    _, _, spre, spost = ck.load_shard(0)
    assert type(spre).__module__ == "gencore_tpu_torch.stats"
    assert type(spost).__module__ == "gencore_tpu_torch.stats"


def test_port_written_checkpoint_resumes_under_the_jax_package(single_inputs,
                                                               tmp_path):
    ckdir = str(tmp_path / "ck")
    tables, pre, post = _port_run(single_inputs, ckdir)
    jt, jpre, jpost = _jax_run(single_inputs, ckdir)
    assert all(isinstance(t, jwindows.LoadedShard) for t in jt)
    assert _recs(jt) == _recs(tables)
    _same_stats(jpre, jpost, pre, post)


def test_cli_shards_and_checkpoint_dir(duplex_inputs, tmp_path, capsys):
    """`--shards 4 --checkpoint_dir D` through the CLI, twice (the second
    run resumes): records and report equal to the single-shard CLI run."""
    bam_path, fa, single_recs, _ = duplex_inputs

    def run(tag, extra):
        out = str(tmp_path / f"{tag}.bam")
        js = str(tmp_path / f"{tag}.json")
        rc = port_cli.main(["-i", bam_path, "-o", out, "-r", fa, "-j", js,
                            "--html", str(tmp_path / f"{tag}.html"),
                            "--device", "cpu", *extra])
        assert rc == 0
        b = bam.BamReader(out).read_all()
        with open(js) as f:
            report = [ln for ln in f.read().splitlines()
                      if '"command"' not in ln]
        return [b.record_bytes(i) for i in range(b.n)], report

    one = run("one", ["--windows", "1"])
    assert sorted(one[0]) == single_recs
    ck = str(tmp_path / "ck")
    assert run("s4", ["--shards", "4", "--checkpoint_dir", ck]) == one
    assert "in-memory run in 4 coordinate shards" in capsys.readouterr().err
    assert run("s4b", ["--shards", "4", "--checkpoint_dir", ck]) == one
    assert os.path.exists(os.path.join(ck, "manifest.json"))
