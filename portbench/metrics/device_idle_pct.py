"""device_idle_pct: the share of the profiled rounds' host-clock time in
which no device row ran (busy time as ``trace.busy_s`` sums it)."""


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["dev"] or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
