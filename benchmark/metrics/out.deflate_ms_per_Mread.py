"""Wall time of the streaming writer's BGZF compression, per million input
reads: the program's write.deflate spans (each native bgzf_write_ex call
of `parallel/streaming.StreamingBamWriter`, its close included, on the
collector thread and at the run's end), summed over the window's
samples."""

from harness import spans

SOURCE = "program_span"
UNIT = "ms/Mread"
LAYER = "streaming writer (parallel/streaming.StreamingBamWriter, csrc/gcio.cpp)"
MOVES = "host_peak_rss_MB"


def read(ctx):
    return spans.ms_per_mread(ctx, ["write.deflate"])
