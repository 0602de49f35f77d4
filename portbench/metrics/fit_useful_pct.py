"""fit_useful_pct: the share of the rows in the fit's batch that the
program writes back (counters ``due_rows`` over ``fit_rows``), summed over
the window's asks outside the profiled rounds; None where nothing fit."""
from portbench.program_spans import counter_sums


def read(ctx):
    got = counter_sums(ctx, ("due_rows", "fit_rows"))
    if got is None or got[0][1] == 0:
        return None
    (due, fit), _ = got
    return 100.0 * due / fit
