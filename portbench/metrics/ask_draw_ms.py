"""ask_draw_ms: milliseconds of the program's ``ask.draw`` span (the bank's
candidate draw and its encoding, inside the ask), the mean over the
window's asks outside the profiled rounds."""
from portbench.program_spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "ask.draw")
