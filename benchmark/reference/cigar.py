"""CIGAR math over BAM-encoded cigar arrays (uint32, len<<4|op).

Behavioral spec: reference src/bamutil.cpp:185-336 (getCigar, isPartOf,
getRefOffset, getMOffsetAndLen) and src/bamutil.cpp:379-383 (getRightRefPos).
"""

from __future__ import annotations

import functools

import numpy as np

# BAM cigar op codes
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF, CBACK = range(10)

OP_CHARS = "MIDNSHP=XB"

# reference src/bamutil.cpp:290-291
QUERY_CONSUM = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.int64)
REF_CONSUM = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.int64)


def ops_lens(cig: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split packed cigar uint32s into (ops, lens) (read-only arrays: a
    sample has few distinct cigars, so the split is cached by value)."""
    return _ops_lens(np.asarray(cig, dtype=np.uint32).tobytes())


@functools.lru_cache(maxsize=4096)
def _ops_lens(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    cig = np.frombuffer(raw, dtype=np.uint32)
    ops, lens = (cig & 0xF).astype(np.int64), (cig >> 4).astype(np.int64)
    ops.setflags(write=False)
    lens.setflags(write=False)
    return ops, lens


def pack(ops, lens) -> np.ndarray:
    return ((np.asarray(lens, dtype=np.uint32) << 4)
            | np.asarray(ops, dtype=np.uint32)).astype(np.uint32)


def to_string(cig: np.ndarray) -> str:
    """Reference-format cigar string: op char BEFORE length (a gencore quirk —
    src/bamutil.cpp:191-202 prints `op << len`, e.g. 'M100S5'). Used only for
    cigar-identity keys (low-complexity check), so the quirk is harmless but
    we keep it for parity with debug output."""
    ops, lens = ops_lens(cig)
    return "".join(f"{OP_CHARS[o]}{l}" for o, l in zip(ops, lens))


def query_len(cig: np.ndarray) -> int:
    ops, lens = ops_lens(cig)
    return int((lens * QUERY_CONSUM[ops]).sum())


def ref_len(cig: np.ndarray) -> int:
    """bam_cigar2rlen equivalent."""
    ops, lens = ops_lens(cig)
    return int((lens * REF_CONSUM[ops]).sum())


def right_ref_pos(pos: int, cig: np.ndarray) -> int:
    """Reference src/bamutil.cpp:379-383: pos + reference span (or -1)."""
    if pos < 0:
        return -1
    return pos + ref_len(cig)


def ref_offset(cig: np.ndarray, bampos: int) -> int:
    """Query offset -> reference offset; -1 inside INS/SOFT_CLIP or past end.

    Reference src/bamutil.cpp:293-314.
    """
    ops, lens = ops_lens(cig)
    ref = 0
    query = 0
    for o, l in zip(ops, lens):
        query += l * QUERY_CONSUM[o]
        ref += l * REF_CONSUM[o]
        if query > bampos:
            if o == CINS or o == CSOFT_CLIP:
                return -1
            return int(ref - REF_CONSUM[o] * (query - bampos))
    return -1


def ref_offsets_vector(cig: np.ndarray, length: int) -> np.ndarray:
    """Vectorized ref_offset for all query positions 0..length-1.

    Returns int32[length]; -1 where the position maps into an insertion or
    soft clip (reference src/bamutil.cpp:293-314 per-position semantics).
    """
    out = np.full(length, -1, dtype=np.int32)
    ops, lens = ops_lens(cig)
    ref = 0
    query = 0
    for o, l in zip(ops, lens):
        l = int(l)
        if QUERY_CONSUM[o]:
            lo = query
            hi = min(query + l, length)
            if lo < length:
                if o == CINS or o == CSOFT_CLIP:
                    out[lo:hi] = -1
                else:
                    # ref - REF_CONSUM*(query_after - i - 1) ... derive directly:
                    # position i in [lo,hi): ref_off = ref + (i - lo)
                    out[lo:hi] = ref + np.arange(hi - lo, dtype=np.int32)
            query += l
        ref += int(l * REF_CONSUM[o])
        if query >= length:
            break
    return out


def first_m_offset_len(cig: np.ndarray) -> tuple[int, int]:
    """Query offset and length of the FIRST M segment (reference
    src/bamutil.cpp:316-336). Returns (0, 0) if no M op."""
    ops, lens = ops_lens(cig)
    query = 0
    for o, l in zip(ops, lens):
        if o == CMATCH:
            return int(query), int(l)
        query += int(l * QUERY_CONSUM[o])
    return 0, 0


def is_part_of(part: np.ndarray, whole: np.ndarray, is_left: bool) -> bool:
    """CIGAR containment test (reference src/bamutil.cpp:204-255).

    `part` is contained by `whole` when, walking ops from the aligned end
    (front if is_left, back otherwise), every op matches in type, and any
    length shortfall occurs only at part's last walked op or immediately
    before a trailing hard-clip.
    """
    ops_p, lens_p = ops_lens(part)
    ops_w, lens_w = ops_lens(whole)
    np_, nw = len(ops_p), len(ops_w)
    if nw < np_:
        return False
    for i in range(np_):
        ip = i if is_left else np_ - i - 1
        iw = i if is_left else nw - i - 1
        if ops_p[ip] != ops_w[iw]:
            return False
        lp, lw = lens_p[ip], lens_w[iw]
        if lp > lw:
            return False
        if lp < lw:
            if i != np_ - 1:
                if i != np_ - 2:
                    return False
                nxt = i + 1
                inx = nxt if is_left else np_ - nxt - 1
                if ops_p[inx] != CHARD_CLIP:
                    return False
    return True


def from_string(s: str) -> np.ndarray:
    """Parse a standard SAM cigar string like '100M' / '5S95M' into packed ops.

    (Standard length-before-op order; used by tests/datagen, not the quirky
    reference to_string order.)
    """
    ops = []
    lens = []
    num = ""
    for c in s:
        if c.isdigit():
            num += c
        else:
            ops.append(OP_CHARS.index(c))
            lens.append(int(num))
            num = ""
    return pack(ops, lens)
