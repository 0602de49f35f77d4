"""score_cov_roofline_pct: the least time of the profiled asks' scoring
(``peaks.score_cov_s`` at each study's observation count) over the device
time of the kernels named ``score_cov*`` in the trace."""
from portbench import peaks, trace


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["asks"]:
        return None
    t = trace.kernel_time(p["dev"], "score_cov")
    if t <= 0:
        return None
    cfg = ctx["cfg"]
    bound = sum(peaks.score_cov_s(a["k_obs"], cfg["mc_samples"], cfg["dim"])
                for a in p["asks"])
    return 100.0 * bound / t
