"""Arithmetic that more than one metric reader shares."""


def unprofiled_asks(ctx):
    """The window's asks outside the profiled rounds of a traced run."""
    p = ctx.get("profile")
    skip = {a["round"] for a in p["asks"]} if p else set()
    return [a for a in ctx["asks"] if a["round"] not in skip]


def stage_ms(ctx, stage):
    """Mean milliseconds a stage's spans take per unprofiled ask."""
    spans = ctx.get("spans")
    asks = unprofiled_asks(ctx)
    if not spans or not asks:
        return None
    return sum(spans.get(a["round"], {}).get(stage, 0.0)
               for a in asks) / len(asks)
