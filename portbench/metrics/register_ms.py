"""register_ms: milliseconds of the program's ``ask.register`` span (the
picked configurations, their encoded rows, the ledger write and the
``Trial`` objects), the mean over the window's asks outside the profiled
rounds."""
from portbench.program_spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "ask.register")
