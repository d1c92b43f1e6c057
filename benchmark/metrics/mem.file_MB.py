"""Resident mapped files at the traced window's peak resident set (RssFile
of /proc/self/status in the program's gauge reading of highest rss):
the shared libraries of torch, CUDA and the port's kernels, and any
file the process maps."""

from harness import memory

SOURCE = "program_counter"
UNIT = "MB"
LAYER = "device runtime (torch and CUDA libraries, CUDA context and driver)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return memory.at_peak_mb(ctx, "file")
