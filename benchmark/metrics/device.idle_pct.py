"""Share of the traced window in which no kernel, copy or memset ran on
the device: 100 minus the union of their intervals in the profiler's
trace over the window's host-clock length."""

from harness import trace

SOURCE = "device_trace"
UNIT = "%"
LAYER = "device"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return trace.idle_pct(ctx.busy_s, ctx.window_s) if ctx.busy_s > 0 else None
