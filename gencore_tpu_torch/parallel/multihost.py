"""Multi-host (multi-process) shard-parallel execution without a
coordinator (port of gencore_tpu/parallel/multihost.py).

Each "host" process owns a subset of coordinate shards: it decodes the BAM,
computes the global checkpoint (deterministic from the stream, so no
coordination needed), runs its shards on its device, and writes
payload/keys/stats files. A merger concatenates outputs in bamComp order
and sums stats — the reduction that parallel/distributed.py does with an
all-gather. The in-process form is parallel/windows.run_sharded.

A host is one run of this module:

    python -m gencore_tpu_torch.parallel.multihost --bam in.bam \\
        --shard_ids 0,2 --n_shards 4 --out_dir D --host_id 0 --device cuda:0
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

from gencore_tpu_torch.options import Options
from gencore_tpu_torch.stats import Stats

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_host(opt: Options, bam_path: str, fasta_path: str, shard_ids: list,
             n_shards: int, out_dir: str, host_id: int, device="cuda"):
    """Run one host's shards; writes shard_<k>.{payload,keys.npy,stats.pkl}
    plus host_<h>.time (in-process wall of decode+compute, excluding the
    interpreter's and torch's import — the scaling-efficiency numerator)."""
    t0 = time.perf_counter()

    from gencore_tpu_torch.engine import VectorEngine
    from gencore_tpu_torch.io import bam as bamio
    from gencore_tpu_torch.io.fasta import FastaRef
    from gencore_tpu_torch.parallel import windows

    fasta = FastaRef.load(fasta_path) if fasta_path else None
    reader = bamio.BamReader(bam_path)
    batch = reader.read_all()
    header = reader.header

    windows.resolve_umi_prefix(opt, batch)
    ck = windows.global_checkpoint(batch)
    wm = windows.global_watermark(batch, header.lengths)
    kind, shard = windows.shard_of_reads(batch, header.lengths, n_shards)

    os.makedirs(out_dir, exist_ok=True)
    for s in shard_ids:
        idx = np.nonzero((kind > 0) & (shard == s))[0]
        if len(idx) == 0:
            continue
        sub = windows.subset_batch(batch, idx)
        eng = VectorEngine(opt, header, fasta=fasta, device=device)
        table = eng.run(sub, checkpoint=ck, watermark=wm, count_pre_reads=False)
        table.build_payload().tofile(os.path.join(out_dir, f"shard_{s}.payload"))
        np.save(os.path.join(out_dir, f"shard_{s}.keys.npy"), table.record_keys())
        with open(os.path.join(out_dir, f"shard_{s}.stats.pkl"), "wb") as f:
            pickle.dump((eng.pre_stats, eng.post_stats), f)

    with open(os.path.join(out_dir, f"host_{host_id}.time"), "w") as f:
        f.write(f"{time.perf_counter() - t0:.6f}")

    # host 0 also records the global per-read pre-stats
    if host_id == 0:
        probe = VectorEngine(opt, header, fasta=None, device=device)
        nm, _ = probe._extract_nm(batch, batch.n)
        pre = Stats(opt.coverage_step, header.names, header.lengths)
        pre.add_reads_vectorized(batch.tid.astype(np.int64),
                                 batch.pos.astype(np.int64),
                                 batch.l_qseq.astype(np.int64), nm)
        with open(os.path.join(out_dir, "global_pre.pkl"), "wb") as f:
            pickle.dump(pre, f)


def merge_hosts(out_dir: str, n_shards: int, header):
    """Merge shard outputs into (sorted record bodies, pre, post stats).
    Reads only files that run_host wrote (the stats are pickles)."""
    from gencore_tpu_torch.parallel.windows import (LoadedShard,
                                                    merge_shard_stats)

    with open(os.path.join(out_dir, "global_pre.pkl"), "rb") as f:
        pre = pickle.load(f)
    post = Stats(pre.coverage_step, header.names, header.lengths, is_post=True)
    recs = []
    for s in range(n_shards):
        pp = os.path.join(out_dir, f"shard_{s}.payload")
        if not os.path.exists(pp):
            continue
        payload = np.fromfile(pp, dtype=np.uint8)
        keys = np.load(os.path.join(out_dir, f"shard_{s}.keys.npy"))
        with open(os.path.join(out_dir, f"shard_{s}.stats.pkl"), "rb") as f:
            spre, spost = pickle.load(f)
        merge_shard_stats(pre, post, spre, spost)
        for body, key in zip(LoadedShard(payload, keys).encoded_records(),
                             keys):
            recs.append((tuple(key), body))
    recs.sort(key=lambda kb: kb[0])
    return [b for _, b in recs], pre, post


def spawn_hosts(opt_kwargs: dict, bam_path: str, fasta_path: str,
                n_hosts: int, n_shards: int, out_dir: str, env=None,
                pin_cores=None, device="cuda"):
    """Launch n_hosts subprocesses, round-robin shard assignment; wait.
    device: passed through to every host ("cpu", "cuda", or a list with
    one entry per host, e.g. ["cuda:0", "cuda:1"]).
    pin_cores: optional list of CPU core ids — host h is pinned to
    pin_cores[h] via taskset, giving disjoint-core scaling numbers (wall
    ratios on shared cores say nothing)."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH", "")) if p)
    procs = []
    for h in range(n_hosts):
        dev = device if isinstance(device, str) else device[h]
        argv = [sys.executable, "-m", "gencore_tpu_torch.parallel.multihost",
                "--options", json.dumps(opt_kwargs), "--bam", bam_path,
                "--fasta", fasta_path, "--shard_ids",
                ",".join(str(s) for s in range(h, n_shards, n_hosts)),
                "--n_shards", str(n_shards), "--out_dir", out_dir,
                "--host_id", str(h), "--device", dev]
        if pin_cores is not None:
            argv = ["taskset", "-c", str(pin_cores[h % len(pin_cores)])] + argv
        procs.append(subprocess.Popen(argv, env=env))
    failed = [rc for rc in (p.wait() for p in procs) if rc != 0]
    if failed:
        raise RuntimeError(f"host process failed with {failed[0]}")


def host_times(out_dir: str, n_hosts: int):
    """Per-host in-process wall times written by run_host."""
    out = []
    for h in range(n_hosts):
        with open(os.path.join(out_dir, f"host_{h}.time")) as f:
            out.append(float(f.read()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gencore_tpu_torch.parallel.multihost",
        description="run one host's coordinate shards")
    p.add_argument("--options", default="{}",
                   help="JSON object of Options fields")
    p.add_argument("--bam", required=True)
    p.add_argument("--fasta", default="")
    p.add_argument("--shard_ids", default="",
                   help="comma-separated shards this host owns")
    p.add_argument("--n_shards", type=int, required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--host_id", type=int, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    run_host(Options(**json.loads(a.options)), a.bam, a.fasta,
             [int(s) for s in a.shard_ids.split(",") if s], a.n_shards,
             a.out_dir, a.host_id, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
