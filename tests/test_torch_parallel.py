"""Job sharding and several devices in one process, on the CPU:
`parallel.mesh.sharded_consensus_step` and `stats_psum` against
gencore_tpu.parallel.mesh on JAX's virtual CPU devices,
`core.kernels.consensus_kernel` against the JAX function, and
`--devices 2 --device cpu` against `--devices 1`. Exact int32/int64 and
byte comparisons: tolerance 0."""

import numpy as np
import pytest
import torch

from gencore_tpu.core import kernels as jkernels
from gencore_tpu.options import Options as JOptions
from gencore_tpu.parallel import mesh as jmesh
from gencore_tpu_torch import cli as port_cli
from gencore_tpu_torch.core import kernels
from gencore_tpu_torch.device import local_devices
from gencore_tpu_torch.io import bam
from gencore_tpu_torch.io.fasta import FastaRef
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.parallel import mesh as pmesh
from gencore_tpu_torch.parallel import pipeline as pipe
from tests.test_engine_equivalence import make_random_workload

torch.set_num_threads(1)


def _vote_batch(J, K, L, seed, ragged=False):
    """Random jobs: members mostly agree with the template; with `ragged`,
    jobs of differing length, absent members, IUPAC codes and positions
    without a reference base."""
    rng = np.random.default_rng(seed)
    bases = np.array([1, 2, 4, 8], dtype=np.uint8)
    seq = bases[rng.integers(0, 4, size=(J, K, L))]
    seq = np.where(rng.random((J, K, L)) < 0.9, seq[:, :1, :], seq)
    qual = rng.integers(10, 40, size=(J, K, L)).astype(np.uint8)
    score = rng.integers(-1, 13, size=(J, K, L)).astype(np.int32)
    valid = np.ones((J, K), dtype=bool)
    pos_valid = np.ones((J, L), dtype=bool)
    refbase = bases[rng.integers(0, 4, size=(J, L))]
    if ragged:
        seq = np.where(rng.random((J, K, L)) < 0.03,
                       rng.integers(0, 16, size=(J, K, L)), seq).astype(np.uint8)
        valid = rng.random((J, K)) < 0.8
        valid[:, 0] = True
        job_len = rng.integers(1, L + 1, size=J)
        pos_valid = np.arange(L)[None, :] < job_len[:, None]
        refbase = np.where(rng.random((J, L)) < 0.2, 0, refbase).astype(np.uint8)
    return seq, qual, score, valid, pos_valid, refbase


def _th(opt):
    rnum, rden = kernels.ratio_fraction(opt.score_percent_req)
    return dict(hi=opt.high_quality, mod=opt.moderate_quality,
                lo=opt.low_quality, base_score_req=opt.base_score_req,
                ratio_num=rnum, ratio_den=rden)


@pytest.mark.parametrize("ragged", [False, True])
def test_consensus_kernel_matches_jax(ragged):
    batch = _vote_batch(24, 5, 64, seed=11, ragged=ragged)
    want = jkernels.consensus_kernel(*batch, **_th(JOptions()))
    got = kernels.consensus_kernel(*[torch.from_numpy(a) for a in batch],
                                   **_th(Options()))
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert (a.numpy() == np.asarray(b)).all()
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_sharded_consensus_matches_jax_mesh(n_devices):
    J = 16
    batch = _vote_batch(J, 4, 128, seed=5, ragged=n_devices == 2)
    want = jmesh.sharded_consensus_step(jmesh.make_mesh(8), *batch,
                                        JOptions())
    mesh = pmesh.make_mesh(n_devices, device="cpu")
    assert mesh.size == n_devices and mesh.rank == 0
    got = pmesh.sharded_consensus_step(mesh, *batch, Options())
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert (a.numpy() == np.asarray(b)).all()
    single = kernels.consensus_kernel(*[torch.from_numpy(a) for a in batch],
                                      **_th(Options()))
    assert int(got[4]) == int(single[2].sum())
    assert int(got[5]) == int((single[3] > 5).sum())


def test_sharded_consensus_needs_even_split():
    batch = _vote_batch(6, 3, 32, seed=2)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        pmesh.sharded_consensus_step(pmesh.make_mesh(4, device="cpu"),
                                     *batch, Options())


def test_stats_psum_matches_jax_mesh():
    mesh = pmesh.make_mesh(8, device="cpu")
    small = np.arange(8 * 5, dtype=np.int32).reshape(8, 5)
    want = np.asarray(jmesh.stats_psum(jmesh.make_mesh(8), small))
    assert (pmesh.stats_psum(mesh, small).numpy() == want).all()
    # beyond int32, where JAX's default 32-bit arrays would wrap
    partials = np.arange(8 * 5, dtype=np.int64).reshape(8, 5) * 1_000_000_007
    got = pmesh.stats_psum(mesh, partials)
    assert got.dtype == torch.int64
    assert (got.numpy() == partials.sum(axis=0)).all()
    with pytest.raises(ValueError, match="partial rows"):
        pmesh.stats_psum(pmesh.make_mesh(4, device="cpu"), partials)


def test_local_devices():
    assert local_devices("cpu", 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        local_devices("cpu", 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_devices("cuda", 2)


def test_local_devices_start_at_the_index_given(monkeypatch):
    """`cuda:1` with 2 devices is cuda:1 and cuda:2, never cuda:0; a run
    past the machine's last GPU raises (a machine of 4 GPUs stands in)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert local_devices("cuda", 1) == cuda[:1]
    assert local_devices("cuda", 4) == cuda
    assert local_devices("cuda:1", 2) == cuda[1:3]
    assert local_devices("cuda:3", 1) == cuda[3:]
    for dev, n in (("cuda", 5), ("cuda:1", 4), ("cuda:3", 2)):
        with pytest.raises(RuntimeError, match="4 CUDA device"):
            local_devices(dev, n)


@pytest.mark.parametrize("device,pid,n_gpus,want", [
    ("cuda", 0, 2, 0), ("cuda", 1, 2, 1), ("cuda", 5, 4, 1),
    ("cuda", 3, 1, 0), ("cuda:1", 0, 2, 1), ("cuda:0", 1, 2, 0)])
def test_rank_device(device, pid, n_gpus, want):
    """Ranks of one host take different GPUs unless the caller names one."""
    from gencore_tpu_torch.parallel.distributed import rank_device
    assert rank_device(device, pid, n_gpus) == torch.device("cuda", want)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("devs")
    sb = make_random_workload(77, n_fragments=220, umi_mode="duplex",
                              contig_len=500_000, n_contigs=2)
    bam_path, fa = str(d / "in.bam"), str(d / "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa)
    return bam_path, fa


def test_pipeline_deals_windows_over_devices(inputs):
    """run_pipelined(devices=[...]) gives window w to devices[w % n] and
    returns the records and stats of the one-device run."""
    bam_path, fa = inputs
    ref = FastaRef.load(fa)
    runs = []
    for devices in (None, [torch.device("cpu")] * 3):
        rdr = bam.BamReader(bam_path)
        tables, pre, post = pipe.run_pipelined(
            Options(), rdr.read_all(), rdr.header, fasta=ref, n_windows=5,
            device="cpu", devices=devices)
        runs.append((pipe.merged_payload(tables).tobytes(), pre.molecule,
                     post.sscs_num, post.dcs_num))
    assert runs[0] == runs[1] and len(runs[0][0]) > 10_000


@pytest.mark.parametrize("path", ["stream", "windows"])
def test_cli_devices_2_equals_devices_1(inputs, tmp_path, monkeypatch, path):
    bam_path, fa = inputs
    extra = ["--stream"] if path == "stream" else ["--windows", "4"]
    if path == "windows":
        monkeypatch.setenv("GENCORE_NO_STREAM", "1")
    outs = []
    for n in (1, 2):
        out = str(tmp_path / f"d{n}.bam")
        js = str(tmp_path / f"d{n}.json")
        rc = port_cli.main(["-i", bam_path, "-o", out, "-r", fa, "-j", js,
                            "--html", str(tmp_path / f"d{n}.html"),
                            "--device", "cpu", "--devices", str(n), *extra])
        assert rc == 0
        b = bam.BamReader(out).read_all()
        with open(js) as f:
            report = [ln for ln in f.read().splitlines()
                      if '"command"' not in ln]
        outs.append(([b.record_bytes(i) for i in range(b.n)], report))
    assert outs[0] == outs[1] and len(outs[0][0]) > 100
