"""Pre/post processing statistics.

Behavioral spec: reference src/stats.{h,cpp} — per-read tallies and genome
depth sampling (stats.cpp:39-121), duplication-level histogram
(stats.cpp:123-133), cluster counters (stats.cpp:135-139), derived rates
(stats.cpp:141-151) and the JSON emitter (stats.cpp:153-193).

In the TPU engine these are accumulated as vectorized numpy/device
histograms and merged across shards with psum; this class is the
host-side accumulator and the JSON surface.
"""

from __future__ import annotations

import math

import numpy as np

MAX_SUPPORTING_READS = 100  # reference stats.h:15


class Stats:
    def __init__(self, coverage_step: int, target_names, target_lens,
                 bed_stats=None, is_post: bool = False):
        self.coverage_step = coverage_step
        self.target_names = list(target_names)
        self.target_lens = list(target_lens)
        self.read = 0
        self.base = 0
        self.read_unmapped = 0
        self.base_unmapped = 0
        self.base_mismatches = 0
        self.read_with_mismatches = 0
        self.cluster = 0
        self.multi_molecule_cluster = 0
        self.molecule = 0
        self.molecule_se = 0
        self.molecule_pe = 0
        self.supporting_histogram = np.zeros(MAX_SUPPORTING_READS, dtype=np.int64)
        self.uncounted_supporting_reads = 0
        self.sscs_num = 0
        self.dcs_num = 0
        self.is_post = is_post
        # genome depth buffers (reference stats.cpp:39-46)
        self.genome_depth = [
            np.zeros(1 + ln // coverage_step, dtype=np.int64) for ln in self.target_lens
        ]
        self.bed_stats = bed_stats  # BedRegions or None

    # --- per-read accounting (reference stats.cpp:101-121) ---
    def add_read(self, tid: int, pos: int, l_qseq: int, nm: int):
        mapped = tid >= 0
        mismatch = nm if mapped else 0
        self.base += l_qseq
        self.read += 1
        self.base_mismatches += mismatch
        if not mapped:
            self.base_unmapped += l_qseq
            self.read_unmapped += 1
        if mismatch > 0:
            self.read_with_mismatches += 1
        if mapped:
            self.stat_depth(tid, pos, l_qseq)

    def add_reads_vectorized(self, tid: np.ndarray, pos: np.ndarray,
                             l_qseq: np.ndarray, nm: np.ndarray):
        """Batch equivalent of repeated add_read."""
        tid = np.asarray(tid)
        mapped = tid >= 0
        self.read += len(tid)
        self.base += int(l_qseq.sum())
        nm_eff = np.where(mapped, nm, 0)
        self.base_mismatches += int(nm_eff.sum())
        self.read_unmapped += int((~mapped).sum())
        self.base_unmapped += int(l_qseq[~mapped].sum())
        self.read_with_mismatches += int((nm_eff > 0).sum())
        self.stat_depth_vectorized(tid[mapped], pos[mapped], l_qseq[mapped])

    def stat_depth(self, tid: int, start: int, length: int):
        """Reference stats.cpp:56-83 (incl. its bounds quirks)."""
        if self.bed_stats is not None:
            self.bed_stats.stat_depth(tid, start, length)
        if tid >= len(self.genome_depth) or tid < 0:
            return
        step = self.coverage_step
        end = start + length
        left_pos = start // step
        right_pos = end // step
        buf = self.genome_depth[tid]
        if right_pos >= len(buf) or left_pos < 0:
            return
        if left_pos == right_pos:
            buf[left_pos] += length
        else:
            buf[left_pos] += (left_pos + 1) * step - start
            buf[right_pos] += end - right_pos * step
            if right_pos > left_pos + 1:
                buf[left_pos + 1:right_pos] += step

    def stat_depth_vectorized(self, tid, start, length):
        if self.bed_stats is not None:
            self.bed_stats.stat_depth_vectorized(tid, start, length)
        step = self.coverage_step
        for c in range(len(self.genome_depth)):
            m = tid == c
            if not m.any():
                continue
            s = start[m].astype(np.int64)
            ln = length[m].astype(np.int64)
            e = s + ln
            lp = s // step
            rp = e // step
            buf = self.genome_depth[c]
            ok = (rp < len(buf)) & (lp >= 0)
            s, ln, e, lp, rp = s[ok], ln[ok], e[ok], lp[ok], rp[ok]
            same = lp == rp
            np.add.at(buf, lp[same], ln[same])
            d = ~same
            np.add.at(buf, lp[d], (lp[d] + 1) * step - s[d])
            np.add.at(buf, rp[d], e[d] - rp[d] * step)
            # interior buckets get += step; use diff trick
            if d.any():
                lo = lp[d] + 1
                hi = rp[d]
                has = hi > lo
                if has.any():
                    delta = np.zeros(len(buf) + 1, dtype=np.int64)
                    np.add.at(delta, lo[has], step)
                    np.add.at(delta, hi[has], -step)
                    buf += np.cumsum(delta[:-1])

    # --- molecule/cluster accounting (reference stats.cpp:123-139) ---
    def add_molecule(self, supporting_reads: int, pe: bool):
        self.molecule += 1
        if supporting_reads < MAX_SUPPORTING_READS:
            self.supporting_histogram[supporting_reads] += 1
        else:
            self.uncounted_supporting_reads += 1
        if pe:
            self.molecule_pe += 1
        else:
            self.molecule_se += 1

    def add_cluster(self, has_multi_molecule: bool):
        self.cluster += 1
        if has_multi_molecule:
            self.multi_molecule_cluster += 1

    def add_sscs(self):
        self.sscs_num += 1

    def add_dcs(self):
        self.dcs_num += 1

    # --- derived (reference stats.cpp:141-151) ---
    def mapped_reads(self) -> int:
        return self.read - self.read_unmapped

    def mapped_bases(self) -> int:
        return self.base - self.base_unmapped

    def mapping_rate(self) -> float:
        return _ieee_div(self.mapped_reads(), self.read)

    def dup_rate(self) -> float:
        # 1.0 - nan = nan; 1.0 - inf = -inf (matches the C++, stats.cpp:145-147)
        return 1.0 - _ieee_div(self.molecule_se + self.molecule_pe * 2,
                               self.mapped_reads())

    def mismatch_rate(self) -> float:
        return _ieee_div(self.base_mismatches, self.mapped_bases())

    def merge_from(self, other: "Stats"):
        """Reduce partial stats from another shard (host-level all-reduce)."""
        for f in ("read", "base", "read_unmapped", "base_unmapped",
                  "base_mismatches", "read_with_mismatches", "cluster",
                  "multi_molecule_cluster", "molecule", "molecule_se",
                  "molecule_pe", "uncounted_supporting_reads", "sscs_num",
                  "dcs_num"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.supporting_histogram += other.supporting_histogram
        for a, b in zip(self.genome_depth, other.genome_depth):
            a += b
        if self.bed_stats is not None and other.bed_stats is not None:
            for ra, rb in zip(
                (r for regs in self.bed_stats.contig_regions for r in regs),
                (r for regs in other.bed_stats.contig_regions for r in regs),
            ):
                ra.count += rb.count

    # --- JSON (reference stats.cpp:153-193) ---
    def report_json_lines(self, has_bed: bool) -> list:
        fmt = _cxx_num
        lines = []
        lines.append(f'\t\t"total_reads": {self.read},')
        lines.append(f'\t\t"total_bases": {self.base},')
        lines.append(f'\t\t"mapped_reads": {self.mapped_reads()},')
        lines.append(f'\t\t"mapped_bases": {self.mapped_bases()},')
        lines.append(f'\t\t"mismatched_bases": {self.base_mismatches},')
        lines.append(f'\t\t"reads_with_mismatched_bases": {self.read_with_mismatches},')
        lines.append(f'\t\t"mismatch_rate": {fmt(self.mismatch_rate())},')
        lines.append(f'\t\t"total_mapping_clusters": {self.cluster},')
        lines.append(f'\t\t"multiple_fragments_clusters": {self.multi_molecule_cluster},')
        lines.append(f'\t\t"total_fragments": {self.molecule},')
        lines.append(f'\t\t"single_end_fragments": {self.molecule_se},')
        lines.append(f'\t\t"paired_end_fragments": {self.molecule_pe},')
        hist = ",".join(str(int(v)) for v in self.supporting_histogram[1:MAX_SUPPORTING_READS])
        lines.append(f'\t\t"duplication_level_histogram": [{hist}],')
        lines.append(f'\t\t"coverage_sampling": {self.coverage_step},')
        lines.append('\t\t"coverage":{')
        nc = len(self.genome_depth)
        for c in range(nc):
            # C round(): half away from zero (values are >= 0 here)
            vals = np.floor(self.genome_depth[c] / self.coverage_step + 0.5).astype(np.int64)
            arr = ",".join(str(int(v)) for v in vals)
            tail = "," if c != nc - 1 else ""
            lines.append(f'\t\t\t"{self.target_names[c]}":[{arr}]{tail}')
        if has_bed and self.bed_stats is not None:
            lines.append("\t\t},")
            lines.extend(self.bed_stats.report_json_lines(self.target_names))
        else:
            lines.append("\t\t}")
        return lines

    def print_summary(self, out):
        """stderr summary (reference stats.cpp:195-221)."""
        p = lambda s: print(s, file=out)
        p(f"Total reads: {self.read}")
        p(f"Total bases: {self.base}")
        mr, mb = self.mapped_reads(), self.mapped_bases()
        p(f"Mapped reads: {mr} ({_pct(mr, self.read)}%)")
        p(f"Mapped bases: {mb} ({_pct(mb, self.base)}%)")
        p(f"Bases mismatched with reference: {self.base_mismatches} ({_pct(self.base_mismatches, mb)}%)")
        p(f"Reads with mismatched bases: {self.read_with_mismatches} ({_pct(self.read_with_mismatches, mr)}%)")
        p(f"Total mapping clusters: {self.cluster}")
        p(f"Mapping clusters with multiple fragments: {self.multi_molecule_cluster}")
        p(f"Total fragments: {self.molecule}")
        p(f"Fragments with single-end reads: {self.molecule_se}")
        p(f"Fragments with paired-end reads: {self.molecule_pe}")
        if not self.is_post:
            p("Duplication level histogram: ")
            for i in range(1, min(MAX_SUPPORTING_READS, 11)):
                if self.supporting_histogram[i] == 0:
                    break
                p(f"    Fragments with {i} duplicates: {int(self.supporting_histogram[i])}")
        else:
            p("")
            p(f"Single Stranded Consensus Sequence (has 'FR' tag): {self.sscs_num}")
            p(f"Duplex Consensus Sequence (has both 'FS' and 'RR' tags): {self.dcs_num}")


def _ieee_div(a, b) -> float:
    """IEEE double division incl. 0/0 -> nan and x/0 -> +-inf, like the
    reference's unguarded C++ divisions (stats.cpp:141-151)."""
    if b:
        return a / b
    if a == 0:
        return float("nan")
    return float("inf") if a > 0 else float("-inf")


def _pct(a, b) -> str:
    """std::to_string(a*100.0/b) — '%f'; 0/0 prints '-nan' on x86 glibc
    (default QNaN has the sign bit set), x/0 prints 'inf'."""
    v = _ieee_div(a * 100.0, b)
    if v != v:
        return "-nan"
    if v == float("inf"):
        return "inf"
    if v == float("-inf"):
        return "-inf"
    return f"{v:.6f}"


def _cxx_num(v: float) -> str:
    """Format a double like C++ default ostream (6 significant digits);
    nan from the reference's 0/0 prints '-nan' (x86 default QNaN sign)."""
    if v != v:
        return "-nan"
    if v == float("inf"):
        return "inf"
    if v == float("-inf"):
        return "-inf"
    if v == 0:
        # C++ ostream prints negative zero as "-0" (html mirror plots)
        import math
        return "-0" if math.copysign(1.0, v) < 0 else "0"
    s = f"{v:.6g}"
    return s
