"""tpe_scores_roofline: the least time of the profiled asks' TPE scoring
(``peaks.tpe_scores_s`` over each study's observations) over the device
time of the kernels named ``tpe_kde_kernel`` in the trace (only its
``tpe_scores`` instance runs on the ask path)."""
from portbench import peaks, trace


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["asks"]:
        return None
    t = trace.kernel_time(p["dev"], "tpe_kde_kernel")
    if t <= 0:
        return None
    cfg = ctx["cfg"]
    bound = sum(peaks.tpe_scores_s(a["k_obs"], cfg["mc_samples"],
                                   cfg["dim"])
                for a in p["asks"])
    return 100.0 * bound / t
