"""Host time of the engine's stages (`engine.py` run_dispatch/run_collect),
per million input reads: the stage totals of sort, umi, grouping,
materialize.host, election, assemble and finalize, summed over the
window's samples. materialize.updispatch nests inside materialize and is
left out. The stages run on several threads, so this is host-seconds,
not wall seconds."""

SOURCE = "program_span"
UNIT = "ms/Mread"
LAYER = "host stages (engine.py run_dispatch)"
MOVES = "host_peak_rss_MB"
STAGES = ["sort", "umi", "grouping", "materialize.host", "election",
          "assemble", "finalize"]


def read(ctx):
    return ctx.stage_ms_per_mread(STAGES)
