"""Post-merge per-cluster flow: duplex pairing, thresholds, tags, stats.

Behavioral spec: reference cluster.cpp:102-188 (the part of clusterByUMI
after the per-group consensusMerge), duplexMerge/duplexMergeBam
(cluster.cpp:190-244). Shared by the scalar oracle and the vectorized
engine — this is per-molecule logic, not per-base, so it stays host-side.
"""

from __future__ import annotations

import numpy as np

from reference.options import Options
from reference.stats import Stats
from reference.umi import _split_nonempty

N4BITS = 15


def duplex_merge(p1, p2) -> int:
    """reference cluster.cpp:190-197."""
    d = 0
    if p1.left is not None and p2.left is not None:
        d += duplex_merge_bam(p1.left, p2.left)
    if p1.right is not None and p2.right is not None:
        d += duplex_merge_bam(p1.right, p2.right)
    return d


# char class of a 4-bit code under BamUtil::fourbits2base
# (bamutil.cpp:149-164): ACGTN keep their code, everything else prints as
# 'N' — two distinct invalid codes compare EQUAL as characters
_CHAR_CLASS = np.full(16, N4BITS, dtype=np.uint8)
for _c in (1, 2, 4, 8, 15):
    _CHAR_CLASS[_c] = _c
_EMPTY = np.zeros(0, dtype=np.int64)


def duplex_merge_rows(s1, s2):
    """(diff, mask_positions) of the reference's duplexMergeBam walk
    (cluster.cpp:199-244) over unpacked 4-bit code rows.

    The reference iterates PACKED bytes with an extra `i++` whenever the
    current byte compares equal. Masking a mismatch at an even position
    writes N into the high nibble of BOTH rows; if the low nibbles agree
    the byte becomes equal, the follow-up odd check takes the equal-byte
    skip, and the walk flips into an odd-position phase where even
    positions are only ever byte-checked — mismatches there are neither
    counted nor masked until an unequal byte flips the phase back. This
    undercount is load-bearing for output parity (a duplex the strict
    per-base count would drop at d>threshold survives), so the walk is
    replicated byte-exactly, reduced to the sparse list of unequal bytes
    (equal bytes skip in either phase with no state change)."""
    len1, len2 = len(s1), len(s2)
    d = abs(len1 - len2)
    n = min(len1, len2)
    if n == 0:
        return d, _EMPTY
    K = (n + 1) // 2
    p1 = np.zeros(2 * K, dtype=np.uint8)
    p2 = np.zeros(2 * K, dtype=np.uint8)
    m1 = min(len1, 2 * K)
    m2 = min(len2, 2 * K)
    p1[:m1] = s1[:m1]
    p2[:m2] = s2[:m2]
    diffb = np.nonzero(((p1[0::2] << 4) | p1[1::2])
                       != ((p2[0::2] << 4) | p2[1::2]))[0]
    if not len(diffb):
        return d, _EMPTY
    c1 = _CHAR_CLASS[p1 & 0xF]
    c2 = _CHAR_CLASS[p2 & 0xF]
    masks = []
    odd_phase = False
    for k in diffb:
        i = 2 * int(k)
        if odd_phase:
            i += 1
            if i >= n:
                break
            if c1[i] != c2[i]:
                d += 1
                masks.append(i)
            odd_phase = False
            continue
        if c1[i] != c2[i]:
            d += 1
            masks.append(i)
            if i + 1 >= n:
                break
            if p1[i + 1] == p2[i + 1]:
                # high nibbles both masked to N, lows agree: the byte is
                # now equal and the reference skips position i+1 entirely
                odd_phase = True
                continue
            if c1[i + 1] != c2[i + 1]:
                d += 1
                masks.append(i + 1)
        else:
            if i + 1 >= n:
                break
            if c1[i + 1] != c2[i + 1]:
                d += 1
                masks.append(i + 1)
    return int(d), np.asarray(masks, dtype=np.int64)


def duplex_merge_bam(b1, b2) -> int:
    """Mask walk-reached disagreeing bases to N/qual0 in BOTH reads;
    return the walk's mismatch count plus the length difference
    (reference cluster.cpp:199-244 via duplex_merge_rows)."""
    d, mism = duplex_merge_rows(b1.seq, b2.seq)
    if len(mism):
        b1.qual[mism] = 0
        b2.qual[mism] = 0
        b1.seq[mism] = N4BITS
        b2.seq[mism] = N4BITS
    return int(d)


def postprocess_cluster(singles: list, has_umi: bool, opt: Options,
                        pre_stats: Stats, post_stats: Stats) -> list:
    """Duplex pass + supporting-reads thresholds + SSCS/DCS tagging + stats.

    `singles` is the per-group consensus pair list in group creation order
    (reference cluster.cpp:107-114). Returns surviving pairs.
    """
    results = []
    if has_umi and not opt.disable_duplex:
        # duplex pass takes from the back (cluster.cpp:119-155); the
        # first partner is looked up by the UMI's halves, which is what
        # is_duplex compares (a UMI that is not two halves has no partner)
        singles = list(singles)
        halves = [_halves(p.umi) for p in singles]
        while singles:
            p1 = singles.pop()
            h1 = halves.pop()
            found = False
            want = None if h1 is None else (h1[1], h1[0])
            for i, p2 in enumerate(singles):
                if want is not None and halves[i] == want:
                    found = True
                    d = duplex_merge(p1, p2)
                    pre_stats.add_molecule(p1.merge_reads + p2.merge_reads,
                                           p1.left is not None and p1.right is not None)
                    if d <= opt.duplex_mismatch_threshold:
                        if p1.merge_reads + p2.merge_reads >= opt.cluster_size_req:
                            p1.is_duplex = True
                            p1.reverse_merge_reads = p2.merge_reads
                            p1.write_sscs_dcs_tag()
                            post_stats.add_dcs()
                            results.append(p1)
                    del singles[i]
                    del halves[i]
                    break
            if not found:
                pre_stats.add_molecule(p1.merge_reads,
                                       p1.left is not None and p1.right is not None)
                if not opt.duplex_only and p1.merge_reads >= opt.cluster_size_req:
                    p1.write_sscs_dcs_tag()
                    post_stats.add_sscs()
                    results.append(p1)
    else:
        for p in singles:
            pre_stats.add_molecule(p.merge_reads,
                                   p.left is not None and p.right is not None)
            if not opt.duplex_only and p.merge_reads >= opt.cluster_size_req:
                p.write_sscs_dcs_tag()
                post_stats.add_sscs()
                results.append(p)
    if results:
        post_stats.add_cluster(len(results) > 1)
    return results


def _halves(umi: str):
    """The two halves is_duplex compares, or None where umi is not two."""
    parts = _split_nonempty(umi, "_")
    return tuple(parts) if len(parts) == 2 else None
