"""Multi-process execution on torch.distributed (port of
gencore_tpu/parallel/distributed.py).

Every process runs the same program, initialized with (coordinator,
num_processes, process_id); the process group is gloo for CPU runs and
NCCL when the processes drive GPUs. This module is that program for the
consensus engine:

  * window ownership: coordinate windows round-robined over processes
    (the window plan is a pure function of the input, so no coordination
    is needed to agree on it — same trick as the global tick checkpoint);
  * each process runs its windows on its device and writes each window's
    payload + bamComp keys to the shared output directory;
  * stats merge across processes with an all-gather of one pickled blob
    per process, merged by process id, then process 0 merges the windows
    and writes the final BAM.

The subprocess form without a coordinator is parallel/multihost.py.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np

from gencore_tpu_torch.options import Options
from gencore_tpu_torch.stats import Stats


def rank_device(device, process_id: int, n_gpus: int):
    """The CUDA device of rank `process_id` on a host with `n_gpus`: the
    one `device` names when it carries an index, else cuda:(process_id
    modulo n_gpus)."""
    import torch
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", process_id % n_gpus)
    return dev


def init_runtime(coordinator: str, num_processes: int, process_id: int,
                 device="cuda", timeout_s: float = 300.0):
    """Bring up torch.distributed for this process: `coordinator` is
    "host:port" of process 0; the backend follows `device` (gloo for the
    CPU, NCCL for CUDA). This process's GPU is made current, so that a
    later device="cuda" means it: the index that `device` names, else
    process_id modulo the GPUs of this host, so that the ranks of one host
    do not share a GPU. A hung rendezvous or collective raises after
    timeout_s."""
    import torch
    import torch.distributed as dist

    from gencore_tpu_torch.device import resolve_device
    if torch.device(device).type == "cuda":
        resolve_device(device)          # raises without a CUDA device
        dev = rank_device(device, process_id, torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def shutdown_runtime():
    """Leave the process group (a no-op when there is none)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _allgather_blobs(blob: bytes) -> list:
    """One variable-length byte blob per process, gathered to every
    process in rank order."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, blob)
    return out


def run_process(opt: Options, bam_path: str, out_dir: str,
                fasta_path: str = "", n_windows: int = 0,
                write_output: bool = True, device="cuda"):
    """One process's share of a distributed run. Requires init_runtime
    first. Returns (pre, post) global stats on process 0, else None."""
    import torch.distributed as dist

    pid = dist.get_rank()
    nproc = dist.get_world_size()

    from gencore_tpu_torch.device import device_scope, resolve_device
    from gencore_tpu_torch.engine import VectorEngine
    from gencore_tpu_torch.io import bam as bamio
    from gencore_tpu_torch.io.fasta import FastaRef
    from gencore_tpu_torch.parallel import pipeline as pipe
    from gencore_tpu_torch.parallel import windows as win

    dev = resolve_device(device)
    fasta = FastaRef.load(fasta_path) if fasta_path else None
    reader = bamio.BamReader(bam_path)
    batch = reader.read_all()
    header = reader.header

    win.resolve_umi_prefix(opt, batch)
    ck = win.global_checkpoint(batch)
    wm = win.global_watermark(batch, header.lengths)
    if n_windows <= 0:
        n_windows = max(nproc, min(64, batch.n // 40_000))
    wins = pipe.plan_windows(batch, header.lengths, n_windows)

    # this process's windows, on this process's device
    my = [w for w in range(len(wins)) if w % nproc == pid]
    local_pre = Stats(opt.coverage_step, header.names, header.lengths)
    local_post = Stats(opt.coverage_step, header.names, header.lengths,
                       is_post=True)
    os.makedirs(out_dir, exist_ok=True)
    for w in my:
        sub = win.subset_batch(batch, wins[w])
        eng = VectorEngine(Options(**{f.name: getattr(opt, f.name)
                                      for f in opt.__dataclass_fields__
                                      .values()}),
                           header, fasta=fasta, device=dev)
        eng._suppress_contig_dbg = True
        with device_scope(dev):
            table = eng.run_collect(eng.run_dispatch(
                sub, checkpoint=ck, watermark=wm, count_pre_reads=False))
        win.merge_shard_stats(local_pre, local_post, eng.pre_stats,
                              eng.post_stats)
        table.build_payload().tofile(
            os.path.join(out_dir, f"win_{w}.payload"))
        np.save(os.path.join(out_dir, f"win_{w}.keys.npy"),
                table.record_keys())

    # per-read pre-stats computed once (process 0's share of the merge)
    if pid == 0:
        probe = VectorEngine(opt, header, fasta=None, device=dev)
        nm, _ = probe._extract_nm(batch, batch.n)
        local_pre.add_reads_vectorized(batch.tid.astype(np.int64),
                                       batch.pos.astype(np.int64),
                                       batch.l_qseq.astype(np.int64), nm)

    # stats reduction: all-gather each process's stats blob (written by
    # this program's own processes), everyone merges by process id; the
    # gather is also the barrier after which every window file is written
    blobs = _allgather_blobs(pickle.dumps((local_pre, local_post)))
    pre = Stats(opt.coverage_step, header.names, header.lengths)
    post = Stats(opt.coverage_step, header.names, header.lengths,
                 is_post=True)
    for blob in blobs:
        spre, spost = pickle.loads(blob)
        win.merge_shard_stats(pre, post, spre, spost)
        pre.read += spre.read
        pre.base += spre.base
        pre.read_unmapped += spre.read_unmapped
        pre.base_unmapped += spre.base_unmapped
        pre.base_mismatches += spre.base_mismatches
        pre.read_with_mismatches += spre.read_with_mismatches
        for c in range(len(pre.genome_depth)):
            pre.genome_depth[c] += spre.genome_depth[c]

    if pid != 0:
        return None
    if write_output:
        recs = []
        for w in range(len(wins)):
            pp = os.path.join(out_dir, f"win_{w}.payload")
            if not os.path.exists(pp):
                # every window was assigned to some process; a missing
                # payload after the gather means a failed window write or
                # shared-FS visibility lag — silent record loss either way
                raise IOError(
                    f"window {w} payload missing after the all-gather: {pp}")
            payload = np.fromfile(pp, dtype=np.uint8)
            keys = np.load(os.path.join(out_dir, f"win_{w}.keys.npy"))
            shard = win.LoadedShard(payload, keys)
            for body, key in zip(shard.encoded_records(), keys):
                recs.append((tuple(key), body))
        recs.sort(key=lambda kb: kb[0])
        writer = bamio.BamWriter(os.path.join(out_dir, "out.bam"), header)
        for _, body in recs:
            writer.write_record(body)
        writer.close()
    return pre, post
