"""Vectorized per-read CIGAR metadata over a columnar batch.

Computes, for a set of records, in pure numpy (no per-read python):
  * cigar equivalence class ids (byte-identity of the packed cigar),
  * query/reference lengths,
  * right reference end positions (BamUtil::getRightRefPos),
  * first-M-segment offset/length (BamUtil::getMOffsetAndLen).

These drive template election fast paths and overlap-scoring geometry.
"""

from __future__ import annotations

import numpy as np

from gencore_tpu_torch.utils.cigar import QUERY_CONSUM, REF_CONSUM, CMATCH


class CigarTable:
    def __init__(self, batch, idx: np.ndarray):
        self.idx = idx
        n = len(idx)
        nc = batch.n_cigar[idx].astype(np.int64)
        cmax = max(int(nc.max()) if n else 1, 1)
        cols = np.arange(cmax, dtype=np.int64)
        base = batch.cigar_off[idx][:, None] + 4 * cols[None, :]
        np.minimum(base, len(batch.data) - 4, out=base)
        d = batch.data
        u32 = (d[base].astype(np.uint32)
               | (d[base + 1].astype(np.uint32) << 8)
               | (d[base + 2].astype(np.uint32) << 16)
               | (d[base + 3].astype(np.uint32) << 24))
        valid = cols[None, :] < nc[:, None]
        u32 = np.where(valid, u32, 0)
        ops = (u32 & 0xF).astype(np.int64)
        lens = (u32 >> 4).astype(np.int64)
        qcon = np.where(valid, QUERY_CONSUM[ops] * lens, 0)
        rcon = np.where(valid, REF_CONSUM[ops] * lens, 0)
        self.n_cigar = nc
        self.ref_len = rcon.sum(axis=1)
        self.query_len = qcon.sum(axis=1)
        self.rrp = batch.pos[idx].astype(np.int64) + self.ref_len  # right ref pos
        # first M segment
        ism = (ops == CMATCH) & valid
        has_m = ism.any(axis=1)
        first_m = np.where(has_m, ism.argmax(axis=1), 0)
        qpre = np.cumsum(qcon, axis=1) - qcon  # exclusive prefix of query consumption
        rows = np.arange(n)
        self.m_off = np.where(has_m, qpre[rows, first_m], 0).astype(np.int64)
        self.m_len = np.where(has_m, lens[rows, first_m], 0).astype(np.int64)
        # cigar class ids: identity of the padded op/len rows. Up to two
        # ops (the overwhelming real-data case: all-M or clip+M) packs
        # into one uint64 so np.unique sorts integers instead of void
        # byte-strings (several times faster on deep windows).
        if cmax == 1:
            _, class_ids = np.unique(u32[:, 0], return_inverse=True)
        elif cmax == 2:
            k64 = u32[:, 0].astype(np.uint64) | (u32[:, 1].astype(np.uint64)
                                                 << np.uint64(32))
            _, class_ids = np.unique(k64, return_inverse=True)
        else:
            key_mat = np.ascontiguousarray(u32)
            keys = key_mat.view(np.dtype(
                (np.void, key_mat.dtype.itemsize * cmax))).ravel()
            _, class_ids = np.unique(keys, return_inverse=True)
        # distinguish different n_cigar with same padded content (impossible:
        # padding is zeros and a real op cannot be len 0 except op 0 with len 0
        # which is degenerate; combine with nc to be safe)
        self.class_id = class_ids * (int(nc.max()) + 2) + nc if n else class_ids
