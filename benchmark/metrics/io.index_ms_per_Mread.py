"""Host time of pass 1 of the streaming path (BGZF inflate and the native
record index, `io/native.py` + `csrc/gcio.cpp`), per million input reads:
the program's `index` stage total, summed over the window's samples."""

SOURCE = "program_span"
UNIT = "ms/Mread"
LAYER = "native I/O (io/native.py, csrc/gcio.cpp)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return ctx.stage_ms_per_mread(["index"])
