"""Pinned host memory at the traced window's peak resident set: the bytes
of the blocks torch's pinned host allocator holds (host_memory_stats'
allocated_bytes.current, cached blocks included), which the uploads of
`core/vote.pinned_upload` and the downloads of `engine._AsyncDownload`
draw on; 0 on the CPU."""

from harness import memory

SOURCE = "program_counter"
UNIT = "MB"
LAYER = "pinned staging (core/vote.pinned_upload, engine._AsyncDownload)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return memory.at_peak_mb(ctx, "pinned")
