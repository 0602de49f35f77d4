"""launches_per_ask: device kernels (copies and sets left out) in the
profiled rounds of a traced run, over the asks in them."""
from portbench import trace


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["dev"] or not p["asks"]:
        return None
    return trace.kernel_count(p["dev"]) / len(p["asks"])
