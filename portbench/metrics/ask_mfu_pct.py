"""ask_mfu_pct: the least time of the window asks' work (``peaks``) over the
asks' host-clock time: for a GP family the fit of the studies that refit,
the factors, the scoring, and the GP-BUCB downdates or the clustering head;
for TPE its scorer over each study's observations (no pending rows are
weighted: the loop tells every trial before the next ask).  Asks in the
profiled rounds, which the profiler slows, are left out."""
from portbench import peaks
from portbench.metrics_common import unprofiled_asks


def ask_bound_s(a, cfg):
    d, S, n = cfg["dim"], cfg["mc_samples"], cfg["batch_size"]
    k = a["k_obs"]
    if cfg["optimizer"] == "tpe":
        return peaks.tpe_scores_s(k, S, d)
    t = peaks.factors_s(k, d) + peaks.score_cov_s(k, S, d)
    if a["due"].any():
        t += peaks.fit_s(k[a["due"]], cfg["fit_steps"], d)
    if cfg["optimizer"] == "clustering":
        t += peaks.cluster_head_s(len(k), cfg["n_top"], n, d)
    else:
        t += sum(peaks.var_downdate_s(k + s, S, d) for s in range(n - 1))
    return t


def read(ctx):
    asks = unprofiled_asks(ctx)
    if not asks:
        return None
    wall = sum(a["ms"] for a in asks) * 1e-3
    return 100.0 * sum(ask_bound_s(a, ctx["cfg"]) for a in asks) / wall
