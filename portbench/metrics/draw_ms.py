"""draw_ms: the median host-clock milliseconds of one ask's candidate draw
(``ParamSpace.sample_columns`` and ``encode_columns`` of B x S rows), timed
alone after the window."""
import statistics


def read(ctx):
    d = ctx.get("draw_ms")
    return statistics.median(d) if d else None
