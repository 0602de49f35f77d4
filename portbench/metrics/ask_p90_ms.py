"""ask_p90_ms: the 90th percentile of the host-clock milliseconds of every
``ask_all`` in the window (synchronized before and after the call)."""
import numpy as np


def read(ctx):
    ms = [a["ms"] for a in ctx["asks"]]
    return float(np.percentile(ms, 90)) if ms else None
