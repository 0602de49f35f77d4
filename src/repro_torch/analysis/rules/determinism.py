"""Determinism rules: wall clocks and entropy where replay must be pure.

The durable service's whole recovery contract is that replaying
the WAL reproduces proposals bit-identically; the scheduler fault
semantics depend on deadlines that NTP steps can't stretch.  Both
die quietly to a stray ``time.time()`` or an OS-entropy RNG.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.lint import Finding, Module, Rule, call_name
from repro_torch.analysis.rules import register

# np.random module-level (global-state) draws — every one bypasses the
# seed plumbing that makes kill->resume replay exact
_GLOBAL_NP_RANDOM = {
    "rand", "randn", "randint", "random", "random_sample", "uniform",
    "normal", "choice", "shuffle", "permutation", "seed",
}
_GLOBAL_STDLIB_RANDOM = {
    "random", "randint", "uniform", "choice", "shuffle", "seed", "gauss",
    "normalvariate", "randrange", "sample",
}


def _imported_bare_time(mod: Module) -> bool:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            if any(a.name == "time" for a in node.names):
                return True
    return False


@register
class WallClockRule(Rule):
    id = "REPRO-D001"
    family = "determinism"
    scopes = ("core", "scheduler", "service")
    description = ("time.time() in core/scheduler/service — deadlines, "
                   "retries and replayable state must use "
                   "time.monotonic()")
    rationale = ("The schedulers' deadline arithmetic must not stretch or "
                 "collapse under an NTP wall-clock step; WAL replay must "
                 "be a pure function of the journal.  Wall clocks belong "
                 "only in user-facing reporting — baseline those.")

    def check(self, mod: Module) -> Iterable[Finding]:
        bare = _imported_bare_time(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            hit = (name == "time.time"
                   or (bare and name == "time")
                   or name in ("datetime.now", "datetime.datetime.now",
                               "datetime.utcnow",
                               "datetime.datetime.utcnow"))
            if hit:
                yield self.finding(
                    mod, node,
                    "wall-clock read — use time.monotonic() for "
                    "durations/deadlines (NTP steps corrupt wall-clock "
                    "arithmetic); baseline only user-facing timing")


@register
class UnseededRngRule(Rule):
    id = "REPRO-D002"
    family = "determinism"
    scopes = ("core", "scheduler", "service")
    description = ("unseeded RNG construction / global-state random draws "
                   "outside explicit seed plumbing")
    rationale = ("Kill->resume replays bit-identical proposals only "
                 "because every RNG stream is seeded and serialized.  "
                 "An OS-entropy generator or a global "
                 "np.random/random draw silently breaks that contract.")

    def check(self, mod: Module) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if (name in ("np.random.default_rng",
                         "numpy.random.default_rng",
                         "random.Random")
                    and not node.args and not node.keywords):
                yield self.finding(
                    mod, node,
                    f"unseeded {name}() draws OS entropy — construct from "
                    "an explicit seed (or restore a serialized state via "
                    "a seeded placeholder)")
            elif name.startswith(("np.random.", "numpy.random.")):
                leaf = name.rsplit(".", 1)[1]
                if leaf in _GLOBAL_NP_RANDOM:
                    yield self.finding(
                        mod, node,
                        f"global-state {name}() — thread a seeded "
                        "np.random.Generator through instead")
            elif name.startswith("random.") and name.count(".") == 1:
                leaf = name.rsplit(".", 1)[1]
                if leaf in _GLOBAL_STDLIB_RANDOM:
                    yield self.finding(
                        mod, node,
                        f"global-state {name}() — use a per-purpose "
                        "seeded random.Random(seed)")


# function-name fragments that mark a journaled / replayed mutation path:
# everything reachable from WAL replay must be a pure function of the
# journal record + prior state
_REPLAY_MARKERS = ("apply_op", "apply_record", "_apply", "replay",
                   "recover", "_commit")

_IMPURE_CALLS = ("time.time", "datetime.now", "datetime.datetime.now",
                 "np.random.default_rng", "numpy.random.default_rng",
                 "random.Random")


@register
class ReplayPurityRule(Rule):
    id = "REPRO-D003"
    family = "determinism"
    scopes = ("service", "studybank.py")
    description = ("wall-clock or RNG reads inside journaled/replayed "
                   "mutation paths")
    rationale = ("Recovery = snapshot + WAL suffix replay.  A "
                 "clock or entropy read inside apply/replay/commit code "
                 "makes the replayed state diverge from the live state "
                 "it must reproduce bit-identically.")

    def check(self, mod: Module) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not any(m in fn.name for m in _REPLAY_MARKERS):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                impure = (name in _IMPURE_CALLS
                          or (name.startswith(("np.random.",
                                               "numpy.random."))
                              and name.rsplit(".", 1)[1]
                              in _GLOBAL_NP_RANDOM)
                          or (name.startswith("random.")
                              and name.count(".") == 1
                              and name.rsplit(".", 1)[1]
                              in _GLOBAL_STDLIB_RANDOM))
                if impure:
                    yield self.finding(
                        mod, node,
                        f"{name}() inside replayed mutation path "
                        f"{fn.name}() — replay must be a pure function "
                        "of the WAL record and prior state")
