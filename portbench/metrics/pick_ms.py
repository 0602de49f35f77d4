"""pick_ms: milliseconds a window ask spends in the pick stage, from CUDA
events around ``bank_prescale_C``, ``bank_absorb`` and ``bank_pick`` or
``bank_cluster_pick``; the mean over the asks outside the profiled
rounds."""
from portbench.metrics_common import stage_ms


def read(ctx):
    return stage_ms(ctx, "pick")
