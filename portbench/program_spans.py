"""The program's own record of the window's asks
(``repro_torch.core.telemetry``), lined up with the harness's asks, for
the metrics that read the program's spans and counters.

The cells call only ``ask_all`` (through ``Fleet.ask``), so the window's
asks are the last ``len(ctx["asks"])`` records whose root span is
``ask``.  They line up when their ask numbers run on by one, they come
from one bank, and the records a profiler saw are exactly the profiled
rounds; those rounds are then left out, as ``fit_ms`` leaves them out.
A record is read by its ``spans`` (``[name, parent, start_ns, end_ns,
family]``, the root first), ``counters``, ``ask``, ``bank`` and
``profiled``.  A program that keeps no such record, or records that do
not line up, give None.
"""


def program_records():
    """The program's records, oldest first; None without a recorder."""
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    return telemetry.records()


def window_records(ctx, records=None):
    """The records of the window's asks outside the profiled rounds, in
    round order, or None when they do not line up."""
    if records is None:
        records = program_records()
    asks = ctx.get("asks") or []
    if not records or not asks:
        return None
    roots = [r for r in records if r.spans and r.spans[0][0] == "ask"]
    if len(roots) < len(asks):
        return None
    mine = roots[-len(asks):]
    if any(b.ask != a.ask + 1 for a, b in zip(mine, mine[1:])):
        return None
    if len({r.bank for r in mine}) != 1:
        return None
    p = ctx.get("profile")
    profiled = {a["round"] for a in p["asks"]} if p else set()
    out = []
    for a, r in zip(asks, mine):
        if bool(r.profiled) != (a["round"] in profiled):
            return None
        if not r.profiled:
            out.append(r)
    return out or None


def span_ms(rec, name):
    """Milliseconds of the record's spans named ``name``, summed."""
    return sum(s[3] - s[2] for s in rec.spans if s[0] == name) * 1e-6


def self_ms(rec):
    """Milliseconds of the root span less its children's."""
    root = rec.spans[0]
    kids = sum(s[3] - s[2] for s in rec.spans if s[1] == 0)
    return (root[3] - root[2] - kids) * 1e-6


def mean_span_ms(ctx, name, records=None):
    """Mean milliseconds a window ask spends in spans named ``name`` (0
    where it has none)."""
    recs = window_records(ctx, records)
    if recs is None:
        return None
    return sum(span_ms(r, name) for r in recs) / len(recs)


def mean_self_ms(ctx, records=None):
    recs = window_records(ctx, records)
    if recs is None:
        return None
    return sum(self_ms(r) for r in recs) / len(recs)


def counter_sums(ctx, names, records=None):
    """Each counter's sum over the window's asks, and their count; None
    when a record lacks one of ``names``."""
    recs = window_records(ctx, records)
    if recs is None or any(k not in r.counters for r in recs for k in names):
        return None
    return [sum(r.counters[k] for r in recs) for k in names], len(recs)
