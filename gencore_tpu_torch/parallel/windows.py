"""Genomic-coordinate window helpers (port of gencore_tpu/parallel/windows.py).

The scaling axis of this domain is the genome coordinate: the reference
proves windowability via its watermark flush (gencore.cpp:324-389) and
bounds same-contig pairs at 100kb (gencore.cpp:300). The window pipeline
(parallel.pipeline, parallel.streaming) cuts work into coordinate windows
with these rules, and its outputs are exactly record-equivalent to a
single-shot run:

  * cluster ownership: a position cluster (tid, left, right) belongs to the
    window owning `left` — every read of a cluster shares the key, so no
    read is split across windows;
  * pass-through (mate-less) reads belong to their own position's window;
  * per-read pre-stats are computed once, globally;
  * the reference's tick-checkpoint threshold quirk (gencore.cpp:409)
    depends on the global stream, so the checkpoint and the final
    watermark are computed globally and injected into every window;
  * window stats merge by summation (Stats.merge_from); outputs merge by
    the bamComp key.

run_sharded is the single-process multi-shard form (`--shards`), with
checkpoint and resume through parallel.resume; parallel.multihost and
parallel.distributed give the shards or windows to several processes by
the same rules.
"""

from __future__ import annotations

import numpy as np

from gencore_tpu_torch.io import bam as bamio
from gencore_tpu_torch.engine import PAIR_GAP_LIMIT, TICK, VectorEngine
from gencore_tpu_torch.options import Options
from gencore_tpu_torch.parallel.resume import WindowCheckpoint
from gencore_tpu_torch.stats import Stats


def cluster_left_keys(batch: bamio.RecordBatch):
    """Vectorized cluster 'left' key + class per record
    (gencore.cpp:295-313). Returns (kind, left) where kind is
    0=dropped, 1=passthrough, 2=clustered."""
    tid = batch.tid.astype(np.int64)
    pos = batch.pos.astype(np.int64)
    mtid = batch.mtid.astype(np.int64)
    mpos = batch.mpos.astype(np.int64)
    isize = batch.isize.astype(np.int64)
    mapped = (tid >= 0) & (pos >= 0)
    primary = (batch.flag & (bamio.FSECONDARY | bamio.FSUPPLEMENTARY)) == 0
    use = mapped & primary
    same_near = (mtid == tid) & (np.abs(mpos - pos) < PAIR_GAP_LIMIT)
    left = np.where(use & same_near & (isize < 0), mpos, pos)
    passthrough = use & ~same_near & (mtid < 0)
    kind = np.where(use, np.where(passthrough, 1, 2), 0)
    return kind, left


def global_checkpoint(batch: bamio.RecordBatch):
    """Last tick checkpoint (tid,pos of every-10000th clustered read,
    gencore.cpp:319-322) over the full stream."""
    kind, _ = cluster_left_keys(batch)
    cidx = np.nonzero(kind == 2)[0]
    if len(cidx) < TICK:
        return -1, -1
    ck = int(cidx[TICK - 1::TICK][-1])
    return int(batch.tid[ck]), int(batch.pos[ck])


def global_watermark(batch: bamio.RecordBatch, header_lengths):
    """Final output-drain watermark over the full stream: lexmin (tid, left)
    cluster key remaining after the last tick's flush sweep
    (gencore.cpp:324-389). Sharded runs inject this into every shard so the
    reported (pre-destructor-drain) post-stats match a single-shot run."""
    tid = batch.tid.astype(np.int64)
    pos = batch.pos.astype(np.int64)
    mtid = batch.mtid.astype(np.int64)
    mpos = batch.mpos.astype(np.int64)
    isize = batch.isize.astype(np.int64)
    kind, left = cluster_left_keys(batch)
    cidx = np.nonzero(kind == 2)[0]
    if len(cidx) < TICK:
        return -1, -1
    tlen = np.array(header_lengths, dtype=np.int64)
    t, l, mt, mp = tid[cidx], left[cidx], mtid[cidx], mpos[cidx]
    same_near = (mt == t) & (np.abs(mp - pos[cidx]) < PAIR_GAP_LIMIT)
    r = np.where(same_near, l + np.abs(isize[cidx]) - 1,
                 -tlen[np.clip(t, 0, len(tlen) - 1)] * (mt + 1) + mp)
    order = np.lexsort((r, l, t))
    st, sl, sr = t[order], l[order], r[order]
    new = np.ones(len(order), dtype=bool)
    new[1:] = (st[1:] != st[:-1]) | (sl[1:] != sl[:-1]) | (sr[1:] != sr[:-1])
    cstart = np.nonzero(new)[0]
    c_tid, c_left, c_right = st[cstart], sl[cstart], sr[cstart]
    first_read = np.minimum.reduceat(cidx[order], cstart)
    for ck in cidx[TICK - 1::TICK][::-1]:
        tb, pb = int(tid[ck]), int(pos[ck])
        fl = (c_tid < tb) | ((c_tid == tb) & (c_left < pb) & (c_right < pb))
        rem = ~fl & (first_read <= ck)
        if rem.any():
            rt, rl = c_tid[rem], c_left[rem]
            j = np.lexsort((rl, rt))[0]
            return int(rt[j]), int(rl[j])
    return -1, -1


def subset_batch(batch: bamio.RecordBatch, idx: np.ndarray) -> bamio.RecordBatch:
    """Zero-copy record subset (shared payload)."""
    return bamio.RecordBatch(batch.data, batch.off[idx], batch.end[idx])


def resolve_umi_prefix(opt: Options, batch: bamio.RecordBatch):
    """Settle `-u auto` once, from the first record (gencore.cpp:206-221),
    so that every shard, window and process uses the same prefix."""
    if opt.umi_prefix == "auto":
        qn0 = batch.qname(0).decode("latin-1") if batch.n else ""
        opt.umi_prefix = ("umi" if "umi_" in qn0
                          else "UMI" if "UMI_" in qn0 else "")


def merge_shard_stats(pre: Stats, post: Stats, spre: Stats, spost: Stats):
    """Fold one shard's (or window's) stats into the global pair: the
    per-read pre stats are computed once globally, so only the cluster and
    molecule counters of `spre` count; `spost` counts whole."""
    pre.cluster += spre.cluster
    pre.multi_molecule_cluster += spre.multi_molecule_cluster
    pre.molecule += spre.molecule
    pre.molecule_se += spre.molecule_se
    pre.molecule_pe += spre.molecule_pe
    pre.supporting_histogram += spre.supporting_histogram
    pre.uncounted_supporting_reads += spre.uncounted_supporting_reads
    post.merge_from(spost)


def shard_of_reads(batch: bamio.RecordBatch, lengths, n_shards: int):
    """(kind, shard): the ownership kind of every read (0 = owned by no
    shard) and the coordinate shard that owns its cluster — equal spans of
    the concatenated genome coordinate of the cluster's left key."""
    kind, left = cluster_left_keys(batch)
    tlen = np.array(lengths, dtype=np.int64)
    base = np.zeros(len(tlen) + 1, dtype=np.int64)
    np.cumsum(tlen, out=base[1:])
    coord = base[np.clip(batch.tid.astype(np.int64), 0, len(tlen) - 1)] + left
    span = (int(base[-1]) + n_shards - 1) // n_shards
    return kind, np.clip(coord // max(span, 1), 0, n_shards - 1)


class LoadedShard:
    """Shard results restored from a checkpoint (resume path)."""

    def __init__(self, payload: np.ndarray, keys: np.ndarray):
        self.payload = payload
        self.keys = keys

    def record_keys(self) -> np.ndarray:
        return self.keys

    def encoded_records(self) -> list:
        out = []
        p = 0
        data = self.payload
        n = len(data)
        while p + 4 <= n:
            bs = int(data[p]) | (int(data[p + 1]) << 8) | \
                (int(data[p + 2]) << 16) | (int(data[p + 3]) << 24)
            out.append(data[p + 4:p + 4 + bs].tobytes())
            p += 4 + bs
        return out

    def build_payload(self) -> np.ndarray:
        return self.payload


def run_sharded(opt: Options, batch: bamio.RecordBatch, header,
                fasta=None, bed=None, n_shards: int = 2,
                checkpoint_dir: str | None = None, device="cuda"):
    """Run the engine over `n_shards` coordinate shards; returns
    (shard_results, pre_stats, post_stats) equivalent to a single-shot run.
    With checkpoint_dir, completed shards are persisted and a resumed run
    skips them (parallel.resume). device: where every shard's device
    programs run."""
    if opt.max_contig != 0:
        raise ValueError("window sharding does not combine with "
                         "--quit_after_contig")
    resolve_umi_prefix(opt, batch)

    # global pre-read stats (each record exactly once)
    pre = Stats(opt.coverage_step, header.names, header.lengths,
                bed_stats=bed, is_post=False)
    post = Stats(opt.coverage_step, header.names, header.lengths,
                 bed_stats=bed.copy_structure() if bed is not None else None,
                 is_post=True)
    # NM extraction via a throwaway engine helper
    probe = VectorEngine(opt, header, fasta=None, device=device)
    nm, _ = probe._extract_nm(batch, batch.n)
    pre.add_reads_vectorized(batch.tid.astype(np.int64), batch.pos.astype(np.int64),
                             batch.l_qseq.astype(np.int64), nm)

    ckpt = None
    if checkpoint_dir is not None:
        ckpt = WindowCheckpoint(checkpoint_dir, opt, n_shards)

    ck = global_checkpoint(batch)
    wm = global_watermark(batch, header.lengths)
    kind, shard = shard_of_reads(batch, header.lengths, n_shards)

    tables = []
    for s in range(n_shards):
        if ckpt is not None and ckpt.is_done(s):
            payload, keys, spre, spost = ckpt.load_shard(s)
            tables.append(LoadedShard(payload, keys))
            merge_shard_stats(pre, post, spre, spost)
            continue
        own = (kind > 0) & (shard == s)
        idx = np.nonzero(own)[0]
        if len(idx) == 0:
            continue
        sub = subset_batch(batch, idx)
        sopt = Options(**{f.name: getattr(opt, f.name)
                          for f in opt.__dataclass_fields__.values()})
        eng = VectorEngine(sopt, header, fasta=fasta,
                           bed=bed.copy_structure() if bed is not None else None,
                           device=device)
        table = eng.run(sub, checkpoint=ck, watermark=wm, count_pre_reads=False)
        tables.append(table)
        if ckpt is not None:
            ckpt.record_shard(s, table.build_payload(), table.record_keys(),
                              eng.pre_stats, eng.post_stats)
        merge_shard_stats(pre, post, eng.pre_stats, eng.post_stats)
    return tables, pre, post


def merged_records(tables) -> list:
    """All output record bodies across shards, in global bamComp order."""
    recs = []
    for t in tables:
        for body, key in zip(t.encoded_records(), t.record_keys()):
            recs.append((tuple(key), body))
    recs.sort(key=lambda kb: kb[0])
    return [b for _, b in recs]
