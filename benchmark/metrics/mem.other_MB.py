"""Anonymous memory outside malloc and the pinned pool at the traced
window's peak resident set: RssAnon + RssShmem less heap in use, heap
held free and pinned blocks, taken as 0 where that is negative. The
CUDA context and driver, and whatever else maps memory itself."""

from harness import memory

SOURCE = "program_counter"
UNIT = "MB"
LAYER = "device runtime (torch and CUDA libraries, CUDA context and driver)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return memory.at_peak_mb(ctx, "other")
