"""Input records of the window's completed samples over the window's wall
seconds (first sample's start to the last one's end), in the traced run:
the throughput a user sees, kept per layer because the host's speed
drifts too far from run to run for an end-to-end bound on it."""

SOURCE = "host_clock"
UNIT = "reads/s"
LAYER = "CLI (cli.py)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return ctx.reads / ctx.window_s if ctx.reads and ctx.window_s > 0 else None
