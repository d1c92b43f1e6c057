"""Two real torch.distributed processes (gloo, CPU) through the port's
parallel/distributed.py: the merged output and stats equal the port's
single-process run and the JAX package's engine on the same input; the
job-sharded vote and the stats all-reduce of parallel/mesh.py across the
two ranks equal the one-process results. Every wait has a time limit, so a
hung rendezvous fails the test instead of eating the suite's clock."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import torch

from gencore_tpu.engine import VectorEngine as JEngine
from gencore_tpu.io import bam as jbam
from gencore_tpu.io.fasta import FastaRef as JFastaRef
from gencore_tpu.options import Options as JOptions
from gencore_tpu_torch.core import kernels
from gencore_tpu_torch.engine import VectorEngine
from gencore_tpu_torch.io import bam
from gencore_tpu_torch.io.fasta import FastaRef
from gencore_tpu_torch.options import Options
from tests.test_engine_equivalence import STAT_FIELDS, make_random_workload
from tests.test_torch_parallel import _th, _vote_batch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
RENDEZVOUS_S = 60     # init_process_group and each collective
PROCESS_S = 240       # one worker, start to exit


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(worker: str):
    """Run `worker` (source text taking its rank as argv[1]) in NPROC
    processes; returns their stdouts. Kills every process on a timeout."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for i in range(NPROC)]
    try:
        outs = [p.communicate(timeout=PROCESS_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    return [so for so, _ in outs]


def test_torch_distributed_two_processes(tmp_path):
    sb = make_random_workload(95, n_fragments=200, umi_mode="duplex",
                              contig_len=500_000, n_contigs=2)
    bam_path, fa = str(tmp_path / "in.bam"), str(tmp_path / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa)
    out_dir = str(tmp_path / "dist")
    worker = textwrap.dedent(f"""
        import sys
        import torch
        torch.set_num_threads(1)
        from gencore_tpu_torch.options import Options
        from gencore_tpu_torch.parallel import distributed as dist
        pid = int(sys.argv[1])
        dist.init_runtime("127.0.0.1:{_free_port()}", {NPROC}, pid,
                          device="cpu", timeout_s={RENDEZVOUS_S})
        r = dist.run_process(Options(), {bam_path!r}, {out_dir!r},
                             fasta_path={fa!r}, n_windows=4, device="cpu")
        dist.shutdown_runtime()
        assert (r is None) == (pid != 0)
        if pid == 0:
            pre, post = r
            import pickle
            with open({out_dir!r} + "/stats.pkl", "wb") as f:
                pickle.dump((pre, post), f)
        assert "jax" not in sys.modules and "gencore_tpu" not in sys.modules
    """)
    _spawn(worker)

    reader = bam.BamReader(bam_path)
    eng = VectorEngine(Options(), reader.header, fasta=FastaRef.load(fa),
                       device="cpu")
    single = eng.run(reader.read_all()).encoded_records()
    dist_out = bam.BamReader(os.path.join(out_dir, "out.bam")).read_all()
    got = [dist_out.record_bytes(i) for i in range(dist_out.n)]
    assert got == single and len(got) > 100
    assert sorted(f for f in os.listdir(out_dir) if f.endswith(".payload")) \
        == [f"win_{w}.payload" for w in range(4)]

    import pickle
    with open(os.path.join(out_dir, "stats.pkl"), "rb") as f:
        pre, post = pickle.load(f)   # written by this test's own worker
    for f in STAT_FIELDS:
        assert getattr(eng.pre_stats, f) == getattr(pre, f), ("pre", f)
        assert getattr(eng.post_stats, f) == getattr(post, f), ("post", f)
    for a, b in zip(eng.pre_stats.genome_depth, pre.genome_depth):
        assert (a == b).all()

    jreader = jbam.BamReader(bam_path)
    jeng = JEngine(JOptions(), jreader.header, fasta=JFastaRef.load(fa))
    assert jeng.run(jreader.read_all()).encoded_records() == got
    for f in STAT_FIELDS:
        assert getattr(jeng.post_stats, f) == getattr(post, f), ("jax", f)


def test_mesh_over_two_ranks(tmp_path):
    """sharded_consensus_step and stats_psum on a process-group mesh: each
    rank's part equals its slice of the one-process vote, the all-reduced
    totals equal the whole's."""
    J = 12
    batch = _vote_batch(J, 4, 64, seed=31, ragged=True)
    np.savez(str(tmp_path / "batch.npz"), *batch)
    worker = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from gencore_tpu_torch.options import Options
        from gencore_tpu_torch.parallel import distributed as dist
        from gencore_tpu_torch.parallel import mesh as pmesh
        pid = int(sys.argv[1])
        dist.init_runtime("127.0.0.1:{_free_port()}", {NPROC}, pid,
                          device="cpu", timeout_s={RENDEZVOUS_S})
        mesh = pmesh.make_mesh(device="cpu", group=True)
        assert (mesh.size, mesh.rank) == ({NPROC}, pid)
        z = np.load({str(tmp_path / "batch.npz")!r})
        batch = [z[k] for k in z.files]
        out = pmesh.sharded_consensus_step(mesh, *batch, Options())
        total = pmesh.stats_psum(mesh, np.arange(5, dtype=np.int64) + 10 * pid)
        np.savez({str(tmp_path)!r} + f"/out_{{pid}}.npz",
                 *[o.numpy() for o in out], total.numpy())
        dist.shutdown_runtime()
    """)
    _spawn(worker)
    want = kernels.consensus_kernel(*[torch.from_numpy(a) for a in batch],
                                    **_th(Options()))
    step = J // NPROC
    for pid in range(NPROC):
        z = np.load(str(tmp_path / f"out_{pid}.npz"))
        got = [z[k] for k in z.files]
        for a, b in zip(got[:4], want):
            assert (a == b[pid * step:(pid + 1) * step].numpy()).all()
        assert int(got[4]) == int(want[2].sum()) > 0
        assert int(got[5]) == int((want[3] > 5).sum())
        assert (got[6] == 2 * np.arange(5) + 10).all()
