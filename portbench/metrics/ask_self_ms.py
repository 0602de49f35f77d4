"""ask_self_ms: milliseconds of the program's root ``ask`` span less its
stage spans, the mean over the window's asks outside the profiled rounds:
what of the ask no stage span covers."""
from portbench.program_spans import mean_self_ms


def read(ctx):
    return mean_self_ms(ctx)
