"""fit_wall_ms: milliseconds of the program's ``ask.obs.fit`` span (the fit
schedule, the hyperparameter fit, its exit to the host and the ledger
write), the mean over every window ask outside the profiled rounds, 0 in
an ask that did not fit."""
from portbench.program_spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "ask.obs.fit")
