"""pick_wall_ms: milliseconds of the program's ``ask.pick`` spans (each
family's pick up to and including its exit to the host), summed per ask,
the mean over the window's asks outside the profiled rounds."""
from portbench.program_spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "ask.pick")
