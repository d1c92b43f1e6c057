"""Job sharding over devices or ranks (port of gencore_tpu/parallel/mesh.py).

Consensus jobs (the [J, K, L] member tensors) are independent of each
other, so sharding J is a pure scale-out: no job talks to another until
the final reduction of the stats. A Mesh here is either

  * a list of devices in one process (`make_mesh(n, device)`): the job
    axis is cut into len(devices) equal parts, part i votes on devices[i],
    and the two totals are plain sums over the parts; or
  * a torch.distributed process group (`make_mesh(group=...)`, after
    parallel.distributed.init_runtime): every rank passes the same whole
    tensors, votes the part its rank owns on its own device, and the
    totals are all-reduced (gloo on the CPU, NCCL between GPUs).

Each part goes through core.kernels.consensus_kernel: the plain vote on
the CPU, the Bins16 instantiation of csrc/vote.cu on a GPU. All of it is
exact integer work.

Production runs over several devices shard coordinate WINDOWS
(parallel.pipeline round-robin, parallel.distributed across processes),
which keeps each window's read matrices local to one device; this module
carries the job-sharded standalone vote and the stats reduction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gencore_tpu_torch.core import kernels
from gencore_tpu_torch.core.vote import to_device
from gencore_tpu_torch.device import (device_scope, local_devices,
                                      resolve_device)


@dataclass
class Mesh:
    """devices: this process's devices (one in rank mode); group: the
    torch.distributed process group, None for a one-process mesh."""
    devices: list
    group: object = None

    @property
    def size(self) -> int:
        if self.group is not None:
            return torch.distributed.get_world_size(self.group)
        return len(self.devices)

    @property
    def rank(self) -> int:
        if self.group is not None:
            return torch.distributed.get_rank(self.group)
        return 0


def make_mesh(n_devices: int | None = None, device="cuda",
              group=None) -> Mesh:
    """One-process mesh over `n_devices` devices starting at `device` (all
    CUDA devices when None; `device="cpu"` gives n times the CPU), or, with
    `group` (a process group, or True for the default one), the mesh of
    that group's ranks with `device` this rank's device."""
    if group is not None:
        if not torch.distributed.is_initialized():
            raise RuntimeError("make_mesh(group=...): torch.distributed is "
                               "not initialized (distributed.init_runtime)")
        if group is True:
            group = torch.distributed.group.WORLD
        return Mesh([resolve_device(device)], group)
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh(local_devices(dev, n_devices))


def _vote_part(dev, part, opt):
    rnum, rden = kernels.ratio_fraction(opt.score_percent_req)
    with device_scope(dev):
        seq, qual, score, valid, pos_valid, refbase = (
            to_device(a, dev) for a in part)
        return kernels.consensus_kernel(
            seq, qual, score, valid, pos_valid, refbase,
            hi=opt.high_quality, mod=opt.moderate_quality,
            lo=opt.low_quality, base_score_req=opt.base_score_req,
            ratio_num=rnum, ratio_den=rden)


def sharded_consensus_step(mesh: Mesh, seq, qual, score, valid, pos_valid,
                           refbase, opt):
    """Run the vote with the job tensors cut over the mesh.

    seq/qual [J, K, L], score [J, K, L], valid [J, K], pos_valid [J, L],
    refbase [J, L] (numpy arrays or tensors); J must be a multiple of the
    mesh size (callers pad with invalid jobs). Returns (new_seq, new_qual,
    diff, minc, total_diff, total_rolled_back): on a one-process mesh the
    four arrays cover all J jobs (gathered onto the first device); on a
    process-group mesh they cover this rank's J / size jobs. The two totals
    are over all J jobs either way (int64 scalars)."""
    args = (seq, qual, score, valid, pos_valid, refbase)
    J = args[0].shape[0]
    n = mesh.size
    if J % n:
        raise ValueError(f"J={J} is not a multiple of the mesh size {n}")
    step = J // n
    if mesh.group is not None:
        r = mesh.rank
        dev = mesh.devices[0]
        outs = _vote_part(dev, [a[r * step:(r + 1) * step] for a in args], opt)
        totals = torch.stack([outs[2].sum(dtype=torch.int64),
                              (outs[3] > 5).sum(dtype=torch.int64)])
        torch.distributed.all_reduce(totals, group=mesh.group)
        return (*outs, totals[0], totals[1])
    parts = [_vote_part(dev, [a[i * step:(i + 1) * step] for a in args], opt)
             for i, dev in enumerate(mesh.devices)]
    first = mesh.devices[0]
    outs = [torch.cat([p[k].to(first) for p in parts]) for k in range(4)]
    total_diff = sum(int(p[2].sum(dtype=torch.int64)) for p in parts)
    rolled = sum(int((p[3] > 5).sum(dtype=torch.int64)) for p in parts)
    return (*outs, torch.tensor(total_diff), torch.tensor(rolled))


def stats_psum(mesh: Mesh, partials):
    """Sum partial stat vectors over the mesh. One-process mesh: partials
    is [size, F], row i is placed on devices[i] and the rows are summed on
    the first device. Process-group mesh: partials is this rank's [F]
    vector and the sum is an all-reduce. Returns an int64 [F] tensor."""
    if mesh.group is not None:
        x = to_device(np.asarray(partials), mesh.devices[0],
                      torch.int64).clone()
        torch.distributed.all_reduce(x, group=mesh.group)
        return x
    rows = np.asarray(partials)
    if rows.shape[0] != mesh.size:
        raise ValueError(f"{rows.shape[0]} partial rows for a mesh of "
                         f"{mesh.size}")
    first = mesh.devices[0]
    placed = [to_device(rows[i], dev, torch.int64)
              for i, dev in enumerate(mesh.devices)]
    return torch.stack([p.to(first) for p in placed]).sum(dim=0)
