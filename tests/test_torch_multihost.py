"""Two subprocess hosts through the port's parallel/multihost.py
(`python -m gencore_tpu_torch.parallel.multihost`, --device cpu): the
merged records and stats equal the port's single-shot run and the JAX
package's multihost merge of the same input. Tolerance 0. And a host's
timer starts after torch and the port's modules are imported, as the
reference host's starts after JAX's."""

import json
import os
import subprocess
import sys

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


# A host process as spawn_hosts starts it (`python -m ...multihost`, here
# through runpy), with time.perf_counter wrapped so that the call that
# starts run_host's timer records which modules are loaded at that moment.
_TIMER_PROBE = r"""
import json, runpy, sys, time
WATCH = ("torch", "gencore_tpu_torch.engine", "gencore_tpu_torch.io.bam",
         "gencore_tpu_torch.io.fasta", "gencore_tpu_torch.parallel.windows")
real = time.perf_counter
seen = []


def probe():
    if sys._getframe(1).f_code.co_name == "run_host":
        seen.append([m for m in WATCH if m in sys.modules])
    return real()


time.perf_counter = probe
sys.argv = ["multihost"] + sys.argv[1:]
try:
    runpy.run_module("gencore_tpu_torch.parallel.multihost",
                     run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print("SEEN", json.dumps(seen))
"""

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_timer_starts_after_the_imports(tmp_path):
    """run_host's host_<h>.time leaves out the interpreter's start and the
    imports of torch and of the port's modules: at the perf_counter call
    that starts its timer they are all in sys.modules (checked by module,
    not by timing)."""
    sb = make_random_workload(97, n_fragments=40, umi_mode="single",
                              contig_len=200_000, n_contigs=1)
    bam_path = str(tmp_path / "in.bam")
    sb.write_bam(bam_path)
    out_dir = str(tmp_path / "host")
    cp = subprocess.run(
        [sys.executable, "-c", _TIMER_PROBE, "--bam", bam_path,
         "--shard_ids", "0,1", "--n_shards", "2", "--out_dir", out_dir,
         "--host_id", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert cp.returncode == 0, cp.stderr[-2000:]
    seen = json.loads(cp.stdout.split("SEEN", 1)[1])
    assert len(seen) == 2   # the timer's start and its end
    assert seen[0] == ["torch", "gencore_tpu_torch.engine",
                       "gencore_tpu_torch.io.bam",
                       "gencore_tpu_torch.io.fasta",
                       "gencore_tpu_torch.parallel.windows"]
    assert multihost.host_times(out_dir, 1)[0] > 0
