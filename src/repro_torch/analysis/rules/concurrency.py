"""Concurrency rules: lock-guard inference, thread hygiene, silent drops.

The schedulers and the service were both fixed, by hand, for the same
class of bug: an attribute protected by a lock in one method and mutated
bare in another (scheduler stats, adapter outstanding counts, drain
flags).  The
lock-guard rule infers the protected set from the code itself, so the
*next* unguarded mutation is a lint finding, not a flaky race.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.lint import (Finding, Module, Rule, call_name,
                                 dotted_name, terminal_name)
from repro_torch.analysis.rules import register

_LOCKISH = re.compile(r"(lock|mutex|cv|cond)", re.IGNORECASE)

# self.<attr>.<method>(...) calls that mutate the attr in place
_MUTATING_METHODS = {
    "append", "extend", "insert", "add", "remove", "discard", "pop",
    "popitem", "clear", "update", "setdefault",
}


def _with_lock_attr(item: ast.withitem) -> Optional[str]:
    """``with self._lock:`` / ``with self._cv:`` -> the attr name."""
    expr = item.context_expr
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and _LOCKISH.search(expr.attr)):
        return expr.attr
    return None


def _self_attr_of_target(t) -> Optional[str]:
    """The ``X`` of a mutation targeting ``self.X``, ``self.X[...]`` or
    ``self.X.Y``."""
    while isinstance(t, (ast.Subscript, ast.Attribute)):
        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            return t.attr
        t = t.value
    return None


def _mutations(node) -> List[Tuple[str, ast.AST]]:
    """(attr, node) for every ``self.X`` mutation in ``node``'s subtree."""
    out: List[Tuple[str, ast.AST]] = []
    for n in ast.walk(node):
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (n.targets if isinstance(n, ast.Assign)
                       else [n.target])
            for t in targets:
                for el in ([t] if not isinstance(t, (ast.Tuple, ast.List))
                           else t.elts):
                    attr = _self_attr_of_target(el)
                    if attr is not None:
                        out.append((attr, n))
        elif isinstance(n, ast.Call):
            f = n.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in _MUTATING_METHODS):
                attr = _self_attr_of_target(f.value)
                if attr is not None:
                    out.append((attr, n))
    return out


@register
class LockGuardRule(Rule):
    id = "REPRO-C201"
    family = "concurrency"
    scopes = ("scheduler", "service", "core")
    description = ("attribute mutated under `with self.<lock>` in one "
                   "method must be lock-held at every other mutation "
                   "site in the class")
    rationale = ("Exactly the bug class fixed by hand in the schedulers "
                 "(stats, submit-after-shutdown) and the service "
                 "(drain/submit races): one bare mutation off the lock "
                 "loses updates under thread races.  `sanitizers.assert_holds(self.X)` "
                 "at the top of a caller-must-hold function counts as "
                 "held.")

    def check(self, mod: Module) -> Iterable[Finding]:
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            guarded: Dict[str, Set[str]] = {}   # attr -> {locks seen}
            # pass 1: attrs mutated under a with-self-lock block
            for w in ast.walk(cls):
                if not isinstance(w, ast.With):
                    continue
                locks = [a for a in map(_with_lock_attr, w.items)
                         if a is not None]
                if not locks:
                    continue
                for attr, _ in _mutations(w):
                    guarded.setdefault(attr, set()).update(locks)
            if not guarded:
                continue
            # pass 2: mutations of guarded attrs outside any such block
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if meth.name == "__init__":
                    continue   # construction is single-threaded
                asserted = self._asserted_locks(meth)
                for attr, node in _mutations(meth):
                    if attr not in guarded:
                        continue
                    if guarded[attr] & asserted:
                        continue   # assert_holds() declares the contract
                    if self._under_lock(mod, node, guarded[attr]):
                        continue
                    locks = "/".join(sorted(guarded[attr]))
                    yield self.finding(
                        mod, node,
                        f"self.{attr} is mutated under self.{locks} "
                        f"elsewhere in {cls.name} but not here — hold "
                        "the lock or declare the contract with "
                        f"assert_holds(self.{sorted(guarded[attr])[0]})")

    @staticmethod
    def _asserted_locks(meth) -> Set[str]:
        out: Set[str] = set()
        for n in ast.walk(meth):
            if (isinstance(n, ast.Call)
                    and terminal_name(n) == "assert_holds" and n.args):
                a = n.args[0]
                if (isinstance(a, ast.Attribute)
                        and isinstance(a.value, ast.Name)
                        and a.value.id == "self"):
                    out.add(a.attr)
        return out

    @staticmethod
    def _under_lock(mod: Module, node: ast.AST, locks: Set[str]) -> bool:
        cur = mod.parents.get(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(cur, ast.With):
                held = {a for a in map(_with_lock_attr, cur.items)
                        if a is not None}
                if held & locks:
                    return True
            cur = mod.parents.get(cur)
        return False


@register
class DaemonThreadRule(Rule):
    id = "REPRO-C202"
    family = "concurrency"
    scopes = ("scheduler", "service", "train")
    description = ("threading.Thread without daemon=True in scheduler/"
                   "service code")
    rationale = ("A non-daemon worker abandoned past its deadline "
                 "blocks interpreter exit for as long as the straggler "
                 "runs.  Every fan-out thread here must be a daemon; "
                 "threads that must complete should be joined "
                 "explicitly, not left to interpreter shutdown.")

    def check(self, mod: Module) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node) not in ("threading.Thread", "Thread"):
                continue
            daemon = next((kw for kw in node.keywords
                           if kw.arg == "daemon"), None)
            ok = (daemon is not None
                  and isinstance(daemon.value, ast.Constant)
                  and daemon.value.value is True)
            if not ok:
                yield self.finding(
                    mod, node,
                    "threading.Thread without daemon=True — a straggler "
                    "on this thread blocks interpreter exit (the "
                    "deadline-cancel contract)")


@register
class SilentExceptRule(Rule):
    id = "REPRO-C203"
    family = "concurrency"
    scopes = ("core", "scheduler", "service")
    description = ("`except Exception` that swallows without re-raise, "
                   "log, counter, or fallback assignment")
    rationale = ("Dropped-trial semantics are deliberate (the paper's "
                 "partial-result contract), but an *invisible* drop is "
                 "undiagnosable in production.  Every broad handler "
                 "must leave a trace: re-raise, log, bump a counter, or "
                 "assign a fallback.")

    def check(self, mod: Module) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._broad(node):
                continue
            if self._has_evidence(node):
                continue
            yield self.finding(
                mod, node,
                "broad except swallows silently — re-raise, log the "
                "drop, bump a stats counter, or assign a fallback")

    @staticmethod
    def _broad(h: ast.ExceptHandler) -> bool:
        if h.type is None:
            return True
        names = []
        if isinstance(h.type, ast.Tuple):
            names = [dotted_name(e) for e in h.type.elts]
        else:
            names = [dotted_name(h.type)]
        return any(n in ("Exception", "BaseException") for n in names)

    @staticmethod
    def _has_evidence(h: ast.ExceptHandler) -> bool:
        bound = h.name
        for n in ast.walk(h):
            if isinstance(n, ast.Raise):
                return True
            if (bound and isinstance(n, ast.Name) and n.id == bound
                    and isinstance(n.ctx, ast.Load)):
                return True
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                return True
            if isinstance(n, ast.Call):
                name = call_name(n).lower()
                if any(tok in name for tok in ("log", "warn", "print",
                                               "bump", "count", "record",
                                               "stat")):
                    return True
            if isinstance(n, ast.Return) and n.value is not None:
                return True
        return False
