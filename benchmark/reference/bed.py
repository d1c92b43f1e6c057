"""Capture-region BED parsing and per-region depth accumulation.

Behavioral spec: reference src/bed.{h,cpp} — tab-split parsing with
chr->tid resolution via the BAM header (bed.cpp:110-169), overlap-length
depth accumulation (bed.cpp:64-79), average depth (bed.h getAvgDepth =
count/(end-start)), and the JSON section emitter (bed.cpp:81-98).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BedRegion:
    chrom: str
    start: int
    end: int
    name: str = ""
    count: int = 0

    def avg_depth(self) -> int:
        """round(count/span) as int (reference bed.h:29-34)."""
        span = self.end - self.start
        if span <= 0:
            return 0
        # C round(): half away from zero
        import math
        return int(math.floor(self.count / span + 0.5))


class BedRegions:
    def __init__(self, n_targets: int):
        self.contig_regions: list = [[] for _ in range(n_targets)]
        self.loaded = False

    @classmethod
    def load(cls, path: str, target_names: list) -> "BedRegions":
        regions = cls(len(target_names))
        tid_of = {name: i for i, name in enumerate(target_names)}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = [p.strip() for p in line.split("\t")]
                if parts[0].startswith("#"):
                    continue
                if len(parts) < 3:
                    continue
                chrom = parts[0]
                try:
                    start, end = int(parts[1]), int(parts[2])
                except ValueError:
                    continue
                name = parts[3] if len(parts) > 3 else ""
                tid = tid_of.get(chrom, -1)
                if 0 <= tid < len(regions.contig_regions):
                    regions.contig_regions[tid].append(BedRegion(chrom, start, end, name))
        regions.loaded = True
        return regions

    def copy_structure(self) -> "BedRegions":
        """Fresh zero-count copy sharing region defs (reference bed.cpp:100-108)."""
        out = BedRegions(len(self.contig_regions))
        for c, regs in enumerate(self.contig_regions):
            out.contig_regions[c] = [BedRegion(r.chrom, r.start, r.end, r.name) for r in regs]
        out.loaded = self.loaded
        return out

    def stat_depth(self, tid: int, start: int, length: int):
        """Reference bed.cpp:64-79: add overlap length to each covered region.

        Note the reference adds min(rEnd,end)-max(rStart,start) without
        clamping at 0, and breaks at the first region starting past `end` —
        regions are assumed sorted. We reproduce both behaviors.
        """
        if tid < 0 or tid >= len(self.contig_regions):
            return
        end = start + length
        for r in self.contig_regions[tid]:
            if r.end < start:
                continue
            if r.start > end:
                break
            r.count += min(r.end, end) - max(r.start, start)

    def _contig_arrays(self, tid: int):
        """Cached (starts, ends, monotonic) arrays for one contig's regions.
        `monotonic` gates the vectorized path: the reference's scan semantics
        (continue on r.end<start, break at first r.start>end, bed.cpp:64-79)
        reduce to two searchsorted bounds only when both starts and ends are
        non-decreasing in file order — true for any sorted BED."""
        cache = getattr(self, "_arr_cache", None)
        if cache is None:
            cache = self._arr_cache = {}
        v = cache.get(tid)
        if v is None:
            regs = self.contig_regions[tid]
            rs = np.array([r.start for r in regs], dtype=np.int64)
            re_ = np.array([r.end for r in regs], dtype=np.int64)
            mono = bool(len(regs) == 0 or
                        ((rs[1:] >= rs[:-1]).all() and (re_[1:] >= re_[:-1]).all()))
            v = cache[tid] = (rs, re_, mono)
        return v

    def stat_depth_vectorized(self, tid: np.ndarray, start: np.ndarray,
                              length: np.ndarray):
        """Batch equivalent of repeated stat_depth (reference bed.cpp:64-79).

        Per contig: region window per read via two searchsorted bounds
        (sorted-BED fast path), flat np.add.at accumulation, one scatter
        back into BedRegion counts. Unsorted contigs take the scalar scan.
        """
        tid = np.asarray(tid)
        start = np.asarray(start, dtype=np.int64)
        length = np.asarray(length, dtype=np.int64)
        for c in range(len(self.contig_regions)):
            regs = self.contig_regions[c]
            if not regs:
                continue
            m = tid == c
            if not m.any():
                continue
            rs, re_, mono = self._contig_arrays(c)
            s = start[m]
            e = s + length[m]
            if not mono:
                for sv, ev in zip(s, e):
                    self.stat_depth(c, int(sv), int(ev - sv))
                continue
            # regions considered: j in [lo, hi) where re[j] >= s (continue
            # guard) and rs[j] <= e (break guard)
            lo = np.searchsorted(re_, s, side="left")
            hi = np.searchsorted(rs, e, side="right")
            cnt = np.maximum(hi - lo, 0)
            tot = int(cnt.sum())
            if tot == 0:
                continue
            ridx = np.repeat(lo, cnt) + (np.arange(tot, dtype=np.int64)
                                         - np.repeat(np.cumsum(cnt) - cnt, cnt))
            rrep_s = np.repeat(s, cnt)
            rrep_e = np.repeat(e, cnt)
            ov = (np.minimum(re_[ridx], rrep_e)
                  - np.maximum(rs[ridx], rrep_s))
            acc = np.zeros(len(regs), dtype=np.int64)
            np.add.at(acc, ridx, ov)
            for j in np.nonzero(acc)[0]:
                regs[j].count += int(acc[j])

    def report_json_lines(self, target_names: list) -> list:
        """coverage_bed JSON section, byte-format-matching bed.cpp:81-98."""
        lines = ['\t\t"coverage_bed":{']
        nc = len(self.contig_regions)
        for c in range(nc):
            contig = target_names[c]
            lines.append(f'\t\t\t"{contig}":[')
            regs = self.contig_regions[c]
            for p, r in enumerate(regs):
                avg = r.avg_depth()
                tail = "," if p != len(regs) - 1 else ""
                lines.append(f'\t\t\t\t["{r.name}",{r.start},{r.end},{avg}]{tail}')
            close = "\t\t\t]" + ("," if c != nc - 1 else "")
            lines.append(close)
        lines.append("\t\t}")
        return lines
