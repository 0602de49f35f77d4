"""factors_ms: milliseconds of the program's ``ask.obs.factors`` span (the
standardization, the Cholesky factors and the prescale, up to the device
copy of the factors), the mean over the window's asks outside the
profiled rounds."""
from portbench.program_spans import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "ask.obs.factors")
