"""UMI extraction and comparison.

Behavioral spec: reference src/bamutil.cpp:23-112 (getUMI),
src/cluster.cpp:41-53 (umiDiff), src/cluster.cpp:246-258 (isDuplex).
Test vectors: src/bamutil.cpp:385-423.
"""

from __future__ import annotations

_UMI_CHARS = frozenset("ATCG_")


def get_umi_from_qname(qname: str, prefix: str) -> str:
    """Extract the UMI from a read name.

    Two modes, matching reference src/bamutil.cpp:40-112:

    * prefix mode (prefix non-empty): locate the last occurrence of ANY
      character of `prefix` in the qname (the reference uses
      string::find_last_of, a character-set search — a deliberate quirk we
      reproduce), then start 2 chars later (skipping the expected '_'
      separator) and take the maximal run of [ATCG_].
    * no-prefix mode: take everything after the last ':' if it is a valid
      UMI ([ATCG] with at most one '_'), else "".
    """
    n = len(qname)
    if prefix:
        # string::find_last_of(prefix): last index of any char in `prefix`
        pos = -1
        pset = set(prefix)
        for i in range(n - 1, -1, -1):
            if qname[i] in pset:
                pos = i
                break
        if pos < 0:
            return ""
        start = pos + 2
        umi_len = 0
        for i in range(start, n):
            if qname[i] not in _UMI_CHARS:
                break
            umi_len += 1
        return qname[start:start + umi_len]

    # no-prefix mode (reference src/bamutil.cpp:65-111)
    sep = qname.rfind(":")
    if sep < 0 or sep >= n - 1:
        return ""
    start = sep + 1
    if start < n - 1 and qname[start] == "_":
        start += 1
    underscores = 0
    for i in range(start, n):
        c = qname[i]
        if c not in _UMI_CHARS:
            return ""
        if c == "_":
            underscores += 1
            if underscores > 1:
                return ""
    return qname[start:]


def umi_diff(umi1: str, umi2: str) -> int:
    """Hamming-with-length-penalty distance (reference src/cluster.cpp:41-53)."""
    diff = abs(len(umi1) - len(umi2))
    for a, b in zip(umi1, umi2):
        if a != b:
            diff += 1
    return diff


def is_duplex(umi1: str, umi2: str) -> bool:
    """True if umi1 == A_B and umi2 == B_A (reference src/cluster.cpp:246-258).

    The reference splits with its util.h `split` which drops empty fields and
    requires exactly two parts on each side.
    """
    p1 = _split_nonempty(umi1, "_")
    p2 = _split_nonempty(umi2, "_")
    if len(p1) != 2 or len(p2) != 2:
        return False
    return p1[0] == p2[1] and p1[1] == p2[0]


def _split_nonempty(s: str, sep: str) -> list[str]:
    """Reference util.h:59-88 split: skips leading separators, keeps interior
    empties only between two separators... in practice for single-char seps it
    behaves like: split and drop empty leading fields. We reproduce by finding
    runs of non-separator chars separated by single separators, skipping
    leading separators.
    """
    if not s:
        return []
    out = []
    i = 0
    n = len(s)
    # find_first_not_of(sep)
    while i < n and s[i] in sep:
        i += 1
    while i < n:
        j = s.find(sep, i)
        if j < 0:
            out.append(s[i:])
            break
        out.append(s[i:j])
        i = j + len(sep)
    return out
