"""glibc's heap in use at the traced window's peak resident set (mallinfo2
uordblks + hblkhd in the program's gauge reading of highest rss): the
host stages' arrays (numpy, torch's CPU tensors, the native core's
buffers) and every other malloc of the process."""

from harness import memory

SOURCE = "program_counter"
UNIT = "MB"
LAYER = "host stages (engine.py run_dispatch)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return memory.at_peak_mb(ctx, "heap_used")
