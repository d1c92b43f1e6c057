"""Share of the host stages' wall time their threads spent off the CPU:
100 x (1 - thread CPU seconds / wall seconds) summed over the leaf stage
spans of the windows' engines on the dispatch and collector threads
(sort, umi, grouping, materialize.host, election, assemble, finalize,
vote.sync: `engine.py` run_dispatch and run_collect). Waiting for the
interpreter lock held by the other thread, for the device (vote.sync) or
for the operating system counts as off the CPU."""

from harness import spans

SOURCE = "program_span"
UNIT = "%"
LAYER = "host stages (engine.py run_dispatch)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return spans.offcpu_pct(ctx)
