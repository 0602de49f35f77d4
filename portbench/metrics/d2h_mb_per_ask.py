"""d2h_mb_per_ask: megabytes (1e6 bytes) the program's designed exits
(``to_host``) return to the host in one ask (counter ``d2h_bytes``), the
mean over the window's asks outside the profiled rounds."""
from portbench.program_spans import counter_sums


def read(ctx):
    got = counter_sums(ctx, ("d2h_bytes",))
    if got is None:
        return None
    (total,), n = got
    return total / n / 1e6
