"""Host time of UMI clustering (the engine's umi and grouping stages), per
million input reads, summed over the window's samples."""

SOURCE = "program_span"
UNIT = "ms/Mread"
LAYER = "host stages (engine.py run_dispatch)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return ctx.stage_ms_per_mread(["umi", "grouping"])
