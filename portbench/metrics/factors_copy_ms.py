"""factors_copy_ms: milliseconds of the program's ``ask.obs.copy`` span
(the factors' copy to the host, timed by CUDA events around it, and their
write into the ledger), the mean over the window's asks outside the
profiled rounds."""
from portbench.program_spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "ask.obs.copy")
