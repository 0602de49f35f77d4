"""trials_per_s: trials proposed and told in the window over the window's
whole host-clock time (asks, evaluation, tells and study restores)."""


def read(ctx):
    return ctx["told"] / ctx["window_s"] if ctx["window_s"] > 0 else None
