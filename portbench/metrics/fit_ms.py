"""fit_ms: milliseconds a window ask spends in the observation stage, from
CUDA events the harness records around the bank's entry points
``fit_hypers_bank``, ``bank_factors`` and ``bank_prescale_X``; the mean
over the asks outside the profiled rounds, which the profiler slows."""
from portbench.metrics_common import stage_ms


def read(ctx):
    return stage_ms(ctx, "fit")
