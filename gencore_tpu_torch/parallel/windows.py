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
  * window stats merge by summation; outputs merge by the bamComp key.

Coordinate sharding with checkpoint/resume (`--shards`) is not ported yet
(ROADMAP queue 1, item 3).
"""

from __future__ import annotations

import numpy as np

from gencore_tpu_torch.io import bam as bamio
from gencore_tpu_torch.engine import PAIR_GAP_LIMIT, TICK


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


def merged_records(tables) -> list:
    """All output record bodies across shards, in global bamComp order."""
    recs = []
    for t in tables:
        for body, key in zip(t.encoded_records(), t.record_keys()):
            recs.append((tuple(key), body))
    recs.sort(key=lambda kb: kb[0])
    return [b for _, b in recs]
