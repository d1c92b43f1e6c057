"""Bytes the vote's results took from the device to the host, per input
read: the program's `wire.d2hMB` counter (engine._vote_collect and its
parsers), which a --debug CLI run puts, summed over the run, on its
`cli.sample` span; summed over the traced window's samples, over their
input reads. None where the samples' spans carry no such attribute."""

from harness import spans

SOURCE = "program_counter"
UNIT = "B/read"
LAYER = "collect (engine._vote_collect, _sparse_parse)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    mb = [s.attrs["wire.d2hMB"] for s in spans.of(ctx) or ()
          if s.name == "cli.sample" and s.attrs and "wire.d2hMB" in s.attrs]
    if not mb or not ctx.reads:
        return None
    return sum(mb) * 1e6 / ctx.reads
