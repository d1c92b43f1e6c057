"""Entry points of the port (port of __graft_entry__.py).

entry(device) -> (fn, example_args): the flagship computation, the
consensus vote over a padded batch of jobs (`kernels.consensus_kernel`:
the plain vote on the CPU, the Bins16 instantiation of csrc/vote.cu on a
GPU), with example tensors on `device`.

dryrun_multichip(n_devices, device): the production window pipeline
(`parallel.pipeline.run_pipelined`, the path of the CLI's --windows and
--devices) over an n-device mesh (`parallel.mesh.make_mesh`), with the
checks of the JAX package's dryrun:

  * the n-device records equal the 1-device records;
  * `mesh.stats_psum` of the per-window stat partials equals the host
    merge and the 1-device stats;
  * the planned rows per window and their spread;
  * a device-busy rebalance: per-window busy time, measured with the
    windows run one at a time on one device, fed back into the window plan
    as per-record weights; adopted only when its spread is smaller, and
    the rebalanced plan must leave the records unchanged;
  * the scaling of two host processes pinned to two disjoint cores
    (`parallel.multihost.spawn_hosts`), best of 2, where the process may
    use two cores or more.

The JAX version also printed the padded rows per window; the port pads no
rows (no shape buckets), so its line says so instead.

    python -m gencore_tpu_torch.entry [--device cuda|cpu] [--devices N]
        [--fragments N]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

VOTE_KW = dict(hi=30, mod=20, lo=15, base_score_req=6, ratio_num=4,
               ratio_den=5)
STAT_COUNTERS = ("read", "base", "sscs_num", "dcs_num", "base_mismatches")
# the engine stages that dispatch to or wait on the device
DEVICE_STAGES = ("vote", "score.dispatch", "materialize.updispatch",
                 "vote.refbase")


def _example_vote_batch(J=8, K=4, L=128, seed=0):
    rng = np.random.default_rng(seed)
    base_choices = np.array([1, 2, 4, 8], dtype=np.uint8)
    seq = base_choices[rng.integers(0, 4, size=(J, K, L))]
    # make members mostly agree with the template
    seq = np.where(rng.random((J, K, L)) < 0.9, seq[:, :1, :], seq)
    qual = rng.integers(10, 40, size=(J, K, L)).astype(np.uint8)
    score = rng.integers(-1, 13, size=(J, K, L)).astype(np.int32)
    valid = np.ones((J, K), dtype=bool)
    pos_valid = np.ones((J, L), dtype=bool)
    refbase = base_choices[rng.integers(0, 4, size=(J, L))]
    return seq, qual, score, valid, pos_valid, refbase


def entry(device="cuda"):
    import torch

    from gencore_tpu_torch.core import kernels
    from gencore_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in _example_vote_batch(J=256, K=4, L=128))

    def fn(seq, qual, score, valid, pos_valid, refbase):
        return kernels.consensus_kernel(seq, qual, score, valid, pos_valid,
                                        refbase, **VOTE_KW)

    return fn, args


def _check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _spread(xs):
    return ((max(xs) - min(xs)) / (sum(xs) / len(xs))
            if xs and sum(xs) else 0.0)


def _dryrun_workload(n_fragments: int, out_dir: str):
    """The ultra-deep paired workload of the JAX dryrun (seed 11, 2 x 4 Mb
    contigs, six UMIs, ~3 reads per fragment). Returns (bam, fasta)."""
    from gencore_tpu_torch.tools.workloads import SyntheticBam
    rng = np.random.default_rng(11)
    sb = SyntheticBam(seed=11, contig_len=4_000_000, n_contigs=2)
    umis = ["AAAA", "CCCC", "GGGG", "TTTT", "ACGT", "TGCA"]
    for _ in range(n_fragments):
        tid = int(rng.integers(0, 2))
        pos1 = int(rng.integers(100, 3_900_000))
        pos2 = max(pos1, pos1 + int(rng.integers(160, 340)) - 150)
        a, b = rng.choice(umis, size=2, replace=False)
        for _ in range(1 + int(rng.poisson(2))):
            sb.add_pair(tid, pos1, pos2, read_len=150, umi=f"{a}_{b}",
                        n_errors=int(rng.random() < 0.3),
                        qual=int(rng.choice([18, 30, 36])))
    bam_path = os.path.join(out_dir, "in.bam")
    fa_path = os.path.join(out_dir, "ref.fa")
    sb.write_bam(bam_path)
    sb.write_fasta(fa_path)
    return bam_path, fa_path


def dryrun_multichip(n_devices: int, device="cuda", n_fragments: int = 27000,
                     busy_reps: int = 5) -> dict:
    """Run the checks above over `n_devices` devices from `device` (with
    "cpu": n times the CPU), print one line and return its numbers.
    `busy_reps`: serialized runs whose median is each busy measurement."""
    from gencore_tpu_torch.io import bam as bamio
    from gencore_tpu_torch.io.fasta import FastaRef
    from gencore_tpu_torch.options import Options
    from gencore_tpu_torch.parallel import mesh as pmesh
    from gencore_tpu_torch.parallel import multihost as mh
    from gencore_tpu_torch.parallel import pipeline as pipe
    from gencore_tpu_torch.parallel import windows as win

    m = pmesh.make_mesh(n_devices, device)
    devs = m.devices
    tmp = tempfile.mkdtemp(prefix="gencore_dryrun_")
    try:
        bam_path, fa_path = _dryrun_workload(n_fragments, tmp)
        fasta = FastaRef.load(fa_path)
        reader = bamio.BamReader(bam_path)
        batch = reader.read_all()

        def run(devices, weights=None, max_inflight=3):
            t0 = time.perf_counter()
            engines: list = []
            tables, _pre, post = pipe.run_pipelined(
                Options(), batch, reader.header, fasta=fasta,
                n_windows=n_devices, device=devices[0], devices=devices,
                max_inflight=max_inflight, engines_out=engines,
                window_weights=weights)
            return (win.merged_records(tables), post, engines,
                    time.perf_counter() - t0)

        run([devs[0]])   # warm both configurations before timing
        run(devs)
        recs1, post1, _, t1 = run([devs[0]])
        recsN, postN, engines, tN = run(devs)
        _check(recs1 == recsN,
               "n-device pipeline output differs from single-device")

        # per-window stat partials, reduced over the mesh
        parts = np.zeros((n_devices, len(STAT_COUNTERS)), dtype=np.int64)
        for i, eng in enumerate(engines):
            for j, c in enumerate(STAT_COUNTERS):
                parts[i % n_devices, j] += int(getattr(eng.post_stats, c))
        reduced = pmesh.stats_psum(m, parts).cpu().tolist()
        host = [int(getattr(postN, c)) for c in STAT_COUNTERS]
        _check(reduced == host, f"stats_psum {reduced} != host merge {host}")
        _check(host == [int(getattr(post1, c)) for c in STAT_COUNTERS],
               "n-device stats differ from single-device")

        def busy_of(engs):
            return [round(sum(e.timer.totals.get(k, 0.0)
                              for k in DEVICE_STAGES), 3) for e in engs]

        # device-busy per window with the windows SERIALIZED on one device
        # (max_inflight=1): windows in flight together share the host's
        # cores, so their timers would measure scheduling, not the window
        def serialized_busy(weights=None, reps=busy_reps):
            rows = [busy_of(run([devs[0]], weights, max_inflight=1)[2])
                    for _ in range(reps)]
            return [round(float(x), 3)
                    for x in np.median(np.array(rows), axis=0)]

        serialized_busy(reps=1)   # warm
        base_busy = serialized_busy()
        base_busy2 = serialized_busy()   # repeat: the measurement noise
        noise = (max(abs(a - b) for a, b in zip(base_busy, base_busy2))
                 / max(sum(base_busy) / len(base_busy), 1e-9))
        wins0 = pipe.plan_windows(batch, reader.header.lengths, n_devices)
        weights = np.full(batch.n, 1.0)
        for w, idx in enumerate(wins0):
            if w < len(base_busy) and len(idx):
                weights[idx] = max(base_busy[w], 1e-6) / len(idx)
        reb_busy = serialized_busy(weights=weights)
        recsR, _, _, _ = run(devs, weights=weights)
        _check(recsR == recsN, "rebalanced window plan changed the output")
        adopted = (reb_busy if _spread(reb_busy) < _spread(base_busy)
                   else base_busy)
        rows_per_win = [len(ix) for ix in wins0]

        # host scaling: N processes pinned to disjoint cores, same total
        # work, T(1 pinned host) / (N * T(N pinned hosts)), best of 2
        eff = None
        eff_line = "pinned-core-scaling=skipped(1 core)"
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) >= 2:
            nh = 2
            opts = {"umi_prefix": "UMI"}
            host_dev = str(devs[0])
            th1 = thN = float("inf")
            for rep in range(2):
                d1 = os.path.join(tmp, f"h1_{rep}")
                dN = os.path.join(tmp, f"hN_{rep}")
                mh.spawn_hosts(opts, bam_path, fa_path, 1, nh, d1,
                               pin_cores=cores[:1], device=host_dev)
                mh.spawn_hosts(opts, bam_path, fa_path, nh, nh, dN,
                               pin_cores=cores[:nh], device=host_dev)
                th1 = min(th1, max(mh.host_times(d1, 1)))
                thN = min(thN, max(mh.host_times(dN, nh)))
                r1, _, _ = mh.merge_hosts(d1, nh, reader.header)
                rN, _, _ = mh.merge_hosts(dN, nh, reader.header)
                _check(r1 == rN, "pinned multihost outputs differ between "
                                 "1 and N hosts")
            eff = th1 / (nh * thN)
            eff_line = (f"pinned-core-scaling: hosts={nh} cores={cores[:nh]} "
                        f"device={host_dev} t1={th1:.2f}s tN={thN:.2f}s "
                        f"efficiency={eff:.2f} (best-of-2)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    res = {"n_devices": n_devices, "devices": [str(d) for d in devs],
           "reads": int(batch.n), "records": len(recsN),
           "record_equivalent": True, "psum_stats": host, "t1_s": t1,
           "tN_s": tN, "device_busy_per_window": base_busy,
           "rebalanced_device_busy": reb_busy,
           "adopted_spread": _spread(adopted), "measurement_noise": noise,
           "planned_rows_per_window": rows_per_win,
           "planned_rows_spread": _spread(rows_per_win),
           "pinned_efficiency": eff}
    print(f"dryrun_multichip({n_devices}): mesh=({m.size},) "
          f"devices={res['devices']} records={len(recsN)} "
          f"record-equivalent=True psum_stats={host} "
          f"t1={t1:.2f}s tN={tN:.2f}s device-busy-per-window={base_busy} "
          f"spread={_spread(base_busy):.2f} "
          f"rebalanced-device-busy={reb_busy} "
          f"rebalanced-spread={_spread(reb_busy):.2f} "
          f"adopted-spread={_spread(adopted):.2f} "
          f"measurement-noise={noise:.2f} "
          f"planned-rows-per-window={rows_per_win} "
          f"planned-rows-spread={_spread(rows_per_win):.3f} "
          f"padded-rows-per-window=none(the port pads no rows) "
          f"{eff_line} OK", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: every CUDA device, or 2 with "
                         "--device cpu)")
    ap.add_argument("--fragments", type=int, default=27000)
    a = ap.parse_args(argv)
    import torch
    fn, args = entry(a.device)
    print("entry(): diff sum", int(fn(*args)[2].sum()))
    n = a.devices or (torch.cuda.device_count() if a.device != "cpu" else 2)
    dryrun_multichip(n, a.device, n_fragments=a.fragments)
    return 0


if __name__ == "__main__":
    sys.exit(main())
