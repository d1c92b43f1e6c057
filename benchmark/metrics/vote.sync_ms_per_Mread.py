"""Host time spent collecting the vote's results (`engine._vote_collect`,
`_sparse_parse`: the program's vote.sync stage), per million input
reads, summed over the window's samples."""

SOURCE = "program_span"
UNIT = "ms/Mread"
LAYER = "collect (engine._vote_collect, _sparse_parse)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return ctx.stage_ms_per_mread(["vote.sync"])
