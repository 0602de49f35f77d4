"""var_downdate_roofline_pct: the least time of the profiled asks' GP-BUCB
downdates (``peaks.var_downdate_s`` for slots 0 .. batch - 2, each study's
active rows growing by one a slot) over the device time of the kernels
named ``var_downdate*``."""
from portbench import peaks, trace


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["asks"]:
        return None
    t = trace.kernel_time(p["dev"], "var_downdate")
    if t <= 0:
        return None
    cfg = ctx["cfg"]
    bound = sum(peaks.var_downdate_s(a["k_obs"] + s, cfg["mc_samples"],
                                     cfg["dim"])
                for a in p["asks"] for s in range(cfg["batch_size"] - 1))
    return 100.0 * bound / t
