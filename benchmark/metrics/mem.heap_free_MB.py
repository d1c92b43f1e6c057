"""Freed heap that glibc holds in its arenas at the traced window's peak
resident set (mallinfo2 fordblks in the program's gauge reading of
highest rss): memory the host stages freed and the allocator kept
rather than returned. Not all of it need be resident."""

from harness import memory

SOURCE = "program_counter"
UNIT = "MB"
LAYER = "host stages (engine.py run_dispatch)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return memory.at_peak_mb(ctx, "heap_free")
