"""setup_s: host-clock seconds from the start of the command to the end of
set-up (imports, the bank and its seeded histories, kernel builds or
loads, the two warm asks)."""


def read(ctx):
    return ctx["setup_s"]
