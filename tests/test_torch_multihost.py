"""Two subprocess hosts through the port's parallel/multihost.py
(`python -m gencore_tpu_torch.parallel.multihost`, --device cpu): the
merged records and stats equal the port's single-shot run and the JAX
package's multihost merge of the same input. Tolerance 0."""

import os

import torch

from gencore_tpu.io import bam as jbam
from gencore_tpu.parallel import multihost as jmultihost
from gencore_tpu_torch.engine import VectorEngine
from gencore_tpu_torch.io import bam
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.parallel import multihost
from tests.test_engine_equivalence import STAT_FIELDS, make_random_workload

torch.set_num_threads(1)


def test_two_host_processes(tmp_path):
    sb = make_random_workload(95, n_fragments=120, umi_mode="single",
                              contig_len=500_000, n_contigs=2)
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    reader = bam.BamReader(bam_path)
    eng = VectorEngine(Options(), reader.header, device="cpu")
    single_recs = sorted(eng.run(reader.read_all()).encoded_records())

    out_dir = str(tmp_path / "hosts")
    multihost.spawn_hosts({}, bam_path, "", n_hosts=2, n_shards=4,
                          out_dir=out_dir, device="cpu")
    merged, pre, post = multihost.merge_hosts(out_dir, 4, reader.header)
    assert sorted(merged) == single_recs and len(merged) > 50
    for f in STAT_FIELDS:
        assert getattr(eng.post_stats, f) == getattr(post, f), ("post", f)
        assert getattr(eng.pre_stats, f) == getattr(pre, f), ("pre", f)
    times = multihost.host_times(out_dir, 2)
    assert len(times) == 2 and all(t > 0 for t in times)

    jdir = str(tmp_path / "jhosts")
    env = dict(os.environ, JAX_PLATFORMS="cpu", GENCORE_PLATFORM="cpu")
    jmultihost.spawn_hosts({}, bam_path, "", n_hosts=2, n_shards=4,
                           out_dir=jdir, env=env)
    jmerged, jpre, jpost = jmultihost.merge_hosts(
        jdir, 4, jbam.BamReader(bam_path).header)
    assert jmerged == merged
    for f in STAT_FIELDS:
        assert getattr(jpost, f) == getattr(post, f), ("jax post", f)
        assert getattr(jpre, f) == getattr(pre, f), ("jax pre", f)


def test_host_options_pass_through(tmp_path):
    """Options given as a dict reach the host processes: a run that asks
    for two supporting reads equals the single-shot run with that option."""
    sb = make_random_workload(96, n_fragments=100, umi_mode="duplex",
                              contig_len=300_000, n_contigs=1)
    bam_path, fa = str(tmp_path / "in.bam"), str(tmp_path / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa)
    from gencore_tpu_torch.io.fasta import FastaRef
    reader = bam.BamReader(bam_path)
    eng = VectorEngine(Options(cluster_size_req=2), reader.header,
                       fasta=FastaRef.load(fa), device="cpu")
    want = sorted(eng.run(reader.read_all()).encoded_records())
    out_dir = str(tmp_path / "hosts")
    multihost.spawn_hosts({"cluster_size_req": 2}, bam_path, fa, n_hosts=2,
                          n_shards=3, out_dir=out_dir, device=["cpu", "cpu"])
    merged, _, post = multihost.merge_hosts(out_dir, 3, reader.header)
    assert sorted(merged) == want
    assert post.sscs_num == eng.post_stats.sscs_num
