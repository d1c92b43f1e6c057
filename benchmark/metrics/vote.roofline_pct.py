"""Share of the roofline reached by the vote kernels (`csrc/vote_window.cu`
and `csrc/vote.cu`) over the traced window: the least time the H100
needs for the records' bytes or int32 operations (harness/roofline.py)
over the kernels' summed time in the trace."""

from harness import roofline

SOURCE = "device_trace"
UNIT = "%"
LAYER = "vote (core/vote.py, csrc/vote_window.cu, csrc/vote.cu)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    t = ctx.window.kernel_s(roofline.VOTE_KERNELS)
    nbytes, ops = roofline.vote_work(ctx.in_bases, ctx.out_bases)
    return roofline.share_pct(nbytes, ops, t)
