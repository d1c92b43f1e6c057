"""Greedy UMI grouping within a position cluster.

Behavioral spec: reference cluster.cpp:55-100 — repeatedly take the
most-frequent UMI (first-in-map-order wins ties, i.e. lexicographically
smallest), sweep all pairs within umiDiff <= threshold into a group, repeat
until no pairs remain. Shared by the scalar oracle and the vectorized
engine (group identity must match exactly; the greedy order is part of the
output contract).

Vectorized formulation: pairs with equal UMIs always travel together, so
the greedy loop runs over *unique* UMIs (lex-sorted = std::map order) with
one numpy distance row per emitted group — O(groups * U * W) instead of
the scalar O(pairs^2) string loop (cluster.cpp:41-53 umiDiff = hamming
over the common prefix + length penalty).
"""

from __future__ import annotations

import numpy as np


def greedy_umi_groups(umis: list, threshold: int) -> list:
    """Partition pair indices 0..n-1 (already in qname map order) into greedy
    UMI groups. Returns a list of index-lists in group creation order.

    Fast path: all UMIs identical -> single group.
    """
    n = len(umis)
    if n == 0:
        return []
    first = umis[0]
    if all(u == first for u in umis):
        return [list(range(n))]

    uniq = sorted(set(umis))
    U = len(uniq)
    uid = {u: k for k, u in enumerate(uniq)}
    ids = np.fromiter((uid[u] for u in umis), np.int64, n)
    counts = np.bincount(ids, minlength=U)

    W = max(len(u) for u in uniq)
    mat = np.zeros((U, W), dtype=np.uint8)
    lens = np.zeros(U, dtype=np.int64)
    for k, u in enumerate(uniq):
        b = u.encode("latin-1")
        mat[k, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[k] = len(b)

    alive = np.ones(U, dtype=bool)
    cnt = counts.copy()
    cols = np.arange(W, dtype=np.int64)[None, :]
    group_of = np.full(U, -1, dtype=np.int64)
    ngroups = 0

    # precompute the full U x U within-threshold matrix when affordable
    # (every group emission then costs one boolean row); fall back to a
    # per-top distance row for very large U
    ok_mat = None
    if U * U * W <= 64_000_000:
        minlen = np.minimum(lens[:, None], lens[None, :])
        ham = np.zeros((U, U), dtype=np.int32)
        for w in range(W):
            c = mat[:, w]
            ham += (c[:, None] != c[None, :]) & (w < minlen)
        ok_mat = (ham + np.abs(lens[:, None] - lens[None, :])) <= threshold

    while alive.any():
        # most-frequent alive UMI; argmax on the lex-sorted axis reproduces
        # the reference's sorted-map tie-break (lex-smallest wins)
        top = int(np.argmax(cnt))
        if ok_mat is not None:
            sel = alive & ok_mat[top]
        else:
            ham = ((mat != mat[top][None, :])
                   & (cols < np.minimum(lens, lens[top])[:, None])).sum(axis=1)
            sel = alive & (ham + np.abs(lens - lens[top]) <= threshold)
        group_of[sel] = ngroups
        ngroups += 1
        alive &= ~sel
        cnt[sel] = 0

    return _emit(group_of, ngroups, ids, n)


def _emit(group_of: np.ndarray, ngroups: int, ids: np.ndarray, n: int) -> list:
    pair_group = group_of[ids]
    order = np.argsort(pair_group, kind="stable")
    bounds = np.searchsorted(pair_group[order], np.arange(ngroups + 1))
    return [order[bounds[g]:bounds[g + 1]].tolist() for g in range(ngroups)]
