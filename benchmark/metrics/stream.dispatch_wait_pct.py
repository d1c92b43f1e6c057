"""Share of pass 2 (`parallel/streaming.run_streaming`'s window loop, span
stream.windows) in which the dispatch thread waited: on the decoder
(dispatch.wait) or on the collector (dispatch.backpressure: the collect
queue full, or the last windows draining), summed over the window's
samples.

Read it beside stream.collect_wait_pct. The thread whose wait share is
near 0 sets the pace of pass 2; the other thread's share is what
shrinking the pace-setter's work could win. When both are low, the two
threads overlap fully."""

from harness import spans

SOURCE = "program_span"
UNIT = "%"
LAYER = "pass-2 pipeline (parallel/streaming.py)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return spans.share_of_pass2_pct(ctx, ["dispatch.wait",
                                          "dispatch.backpressure"])
