"""The reference over a sample cut into parts by coordinate, each part run
by its own process, with the result of one run over the whole file.

The oracle (`oracle.OracleEngine`, a frozen copy) flushes its clusters
every 10,000 reads with the proper-pair UMI threshold and finishes the
clusters left at the end of the file with the stricter one, and it counts
in the reported post-stats only the records below the last flush's
watermark (gencore.cpp:324-409). A part is run so that all three come out
as in the whole run:

  * its read counter starts at the number of reads before the part, so
    it flushes at the same reads as the whole run;
  * a part that is not the last one ends with a flush of everything at
    the proper threshold, as the first flush of the next part does in the
    whole run (every part holds far more than 10,000 reads), and all its
    records count in the post-stats;
  * the last part finishes as the whole run does.

Parts must not share a cluster: they are cut between targets that lie far
apart, and no read pair spans two of them.
"""

from __future__ import annotations

import numpy as np

from reference import bam as bamio
from reference.oracle import OracleEngine, oread_from_batch


FLUSH_EVERY = 10000   # the oracle's watermark flush period, in reads


class PartEngine(OracleEngine):
    def run_part(self, batch: bamio.RecordBatch, reads_before: int,
                 last: bool, qual_shift: int = 0) -> list:
        """The part's output records in file order. qual_shift > 0 drops
        that many low bits of every base quality as it is read (the
        control's narrower storage; 0 for the reference itself)."""
        opt = self.opt
        self._tick = reads_before
        for i in range(batch.n):
            tid = int(batch.tid[i])
            pos = int(batch.pos[i])
            self.pre_stats.add_read(tid, pos, int(batch.l_qseq[i]),
                                    batch.get_int_tag(i, b"NM", 0))
            if tid < 0 or pos < 0:
                raise ValueError("a part holds an unmapped read")
            if int(batch.flag[i]) & (bamio.FSECONDARY | bamio.FSUPPLEMENTARY):
                continue
            r = oread_from_batch(batch, i)
            if qual_shift:
                r.qual = (r.qual >> qual_shift) << qual_shift
            self._add_to_proper_cluster(r)
        if last:
            self._finish()
        else:
            self._flush(len(self.header.names), 0)
        self.out_records.sort(key=lambda kr: kr[0])
        out = [r for _, r in self.out_records]
        wt, wp = self._wm if last else (1 << 31, 0)
        if wp != -1:
            for r in out:
                st = r.tid if r.tid >= 0 else 0x7FFFFFFF
                if st < wt or (st == wt and r.pos < wp):
                    nm_out = r.nm_new if r.nm_new is not None else r.nm_val
                    self.post_stats.add_read(r.tid, r.pos, r.l_qseq, nm_out)
        return out


def subset(batch: bamio.RecordBatch, lo: int, hi: int) -> bamio.RecordBatch:
    """Records lo..hi-1 of a batch, as a batch over the same buffer."""
    return bamio.RecordBatch(batch.data, batch.off[lo:hi].copy(),
                             batch.end[lo:hi].copy())


def cut_points(batch: bamio.RecordBatch, starts: list) -> np.ndarray:
    """Record indices at which parts begin: the first record at or after
    each (tid, pos) in starts, which must lie in coordinate order."""
    key = batch.tid.astype(np.int64) * (1 << 32) + batch.pos.astype(np.int64)
    want = np.array([t * (1 << 32) + p for t, p in starts], dtype=np.int64)
    return np.searchsorted(key, want, side="left")
