"""The work a kernel family must do for a window's records, and the least
time an H100 could take for it.

The counts come from the records the benchmark generated and the records
the program wrote, never from the program's counters or padded widths:

  * vote: each input read of length l is read once as base, quality and
    overlap score (3 l bytes); each output consensus record of length l
    is written once as base and quality (2 l bytes); 10 int32 operations
    per (member, position);
  * upload and score: each input read is read as 4-bit bases and quality
    bytes (1.5 l) and written as the base, quality and score the vote
    needs (3 l); per (row, position) 16 int32 operations for the sparse
    route's upload_score kernel, 8 for the dense route's unpack and 12
    for its score map.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (80 GB HBM3), NVIDIA's data sheet, at its 700 W limit.
PEAK = {
    "hbm_bytes_per_s": 3.35e12,
    # 132 SMs x 64 INT32 lanes x 1.98 GHz
    "int32_ops_per_s": 16.7e12,
}

VOTE_KERNELS = ("vote_window_kernel", "vote_kernel", "decide_kernel")
UPLOAD_OPS = {"upload_score_kernel": 16, "upload_unpack_kernel": 8,
              "score_map_kernel": 12}


def vote_work(in_bases: int, out_bases: int) -> tuple:
    """(bytes, int32 ops) of the vote over in_bases input and out_bases
    output positions."""
    return 3 * in_bases + 2 * out_bases, 10 * in_bases


def upload_work(in_bases: int, kernels: set) -> tuple:
    """(bytes, int32 ops) of upload and score over in_bases positions,
    for the upload kernels that ran."""
    ops = sum(UPLOAD_OPS[k] for k in kernels if k in UPLOAD_OPS)
    return int(4.5 * in_bases), ops * in_bases


def bound_s(nbytes: float, ops: float) -> tuple:
    """(least seconds, which bound binds: 'bytes' or 'int32')."""
    tb = nbytes / PEAK["hbm_bytes_per_s"]
    to = ops / PEAK["int32_ops_per_s"]
    return (tb, "bytes") if tb >= to else (to, "int32")


def share_pct(nbytes: float, ops: float, kernel_s: float):
    """The share of the roofline, in %, or None where no kernel time was
    read (a share is never reported as 0)."""
    if kernel_s <= 0 or (nbytes <= 0 and ops <= 0):
        return None
    return 100.0 * bound_s(nbytes, ops)[0] / kernel_s
