"""Share of the roofline reached by the upload-and-score kernels
(`csrc/upload_score.cu` on the sparse route; `csrc/upload_dense.cu`'s
unpack and score map on the dense route) over the traced window: the
least time the H100 needs for the records' bytes or int32 operations
(harness/roofline.py) over the kernels' summed time in the trace."""

from harness import roofline

SOURCE = "device_trace"
UNIT = "%"
LAYER = "upload + score (core/kernels.py, csrc/upload_score.cu, csrc/upload_dense.cu)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    ran = {k for k in roofline.UPLOAD_OPS if ctx.window.kernel_s([k]) > 0}
    t = ctx.window.kernel_s(ran)
    nbytes, ops = roofline.upload_work(ctx.in_bases, ran)
    return roofline.share_pct(nbytes, ops, t)
