"""Vectorized UMI extraction from qname byte matrices.

Same semantics as utils.umi.get_umi_from_qname (reference
bamutil.cpp:23-112) but computed for all reads at once in numpy:
returns per-read (start, length) of the UMI substring within the qname.
Cross-validated against the scalar parser in tests.
"""

from __future__ import annotations

import numpy as np

_UMI_CHAR = np.zeros(256, dtype=bool)
for c in b"ATCG_":
    _UMI_CHAR[c] = True


def umi_spans(qmat: np.ndarray, qlen: np.ndarray, prefix: str):
    """Compute UMI substring spans.

    Args: qmat uint8[N, W] (0-padded qnames), qlen int[N].
    Returns (start int64[N], length int64[N]); length 0 = no UMI.
    """
    n, w = qmat.shape
    if n == 0:
        return (np.zeros(0, dtype=np.int64),) * 2

    # threaded native scan (numpy fallback below is cross-validated
    # against it in tests)
    from gencore_tpu_torch.io import native
    if native.get_lib() is not None:
        if prefix:
            pset = np.zeros(256, dtype=np.uint8)
            for ch in prefix.encode():
                pset[ch] = 1
        else:
            pset = np.zeros(256, dtype=np.uint8)
        got = native.umi_spans(qmat, qlen, pset, _UMI_CHAR,
                               1 if prefix else 0)
        if got is not None:
            return got

    cols = np.arange(w, dtype=np.int64)[None, :]
    in_q = cols < qlen[:, None]
    rows = np.arange(n)

    if prefix:
        pset = np.zeros(256, dtype=bool)
        for ch in prefix.encode():
            pset[ch] = True
        isp = pset[qmat] & in_q
        has = isp.any(axis=1)
        # last occurrence of any prefix char
        pos = w - 1 - np.argmax(isp[:, ::-1], axis=1)
        start = pos + 2
        valid = _UMI_CHAR[qmat] & in_q
        beyond = (~valid) & (cols >= start[:, None])
        stop = np.where(beyond.any(axis=1), beyond.argmax(axis=1), qlen)
        length = np.maximum(stop - start, 0)
        length = np.where(has, length, 0)
        start = np.where(has, start, 0)
        return start.astype(np.int64), length.astype(np.int64)

    # no-prefix mode: everything after the last ':', validated
    isc = (qmat == ord(":")) & in_q
    has = isc.any(axis=1)
    sep = w - 1 - np.argmax(isc[:, ::-1], axis=1)
    ok = has & (sep < qlen - 1)
    start = sep + 1
    first_ch = qmat[rows, np.clip(start, 0, w - 1)]
    skip = ok & (start < qlen - 1) & (first_ch == ord("_"))
    start = start + skip
    # all chars in [start, qlen) must be UMI chars, with <= 1 underscore
    tail = (cols >= start[:, None]) & in_q
    invalid = tail & ~_UMI_CHAR[qmat]
    ok &= ~invalid.any(axis=1)
    n_us = (tail & (qmat == ord("_"))).sum(axis=1)
    ok &= n_us <= 1
    length = np.where(ok, qlen - start, 0)
    start = np.where(ok, start, 0)
    return start.astype(np.int64), length.astype(np.int64)


def umi_keys(qmat: np.ndarray, start: np.ndarray, length: np.ndarray):
    """Fixed-width byte keys of the UMI substrings (for vectorized
    equality/factorization). Returns (keys S-array, max_width)."""
    n, w = qmat.shape
    umax = max(int(length.max()) if n else 1, 1)
    cols = np.arange(umax, dtype=np.int64)[None, :]
    g = np.clip(start[:, None] + cols, 0, w - 1)
    m = qmat[np.arange(n)[:, None], g]
    m[cols >= length[:, None]] = 0
    m = np.ascontiguousarray(m)
    return m.view(f"S{umax}").ravel(), umax


def umi_string(qmat: np.ndarray, start: np.ndarray, length: np.ndarray,
               i: int) -> str:
    s, ln = int(start[i]), int(length[i])
    return qmat[i, s:s + ln].tobytes().decode("latin-1")
