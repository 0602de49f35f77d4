"""Durability rules: journal-before-apply and atomic checkpoint writes.

The service's crash contract: every mutation is fsync'd to the
WAL *before* it applies, and every checkpoint publish is
write-tmp -> flush -> fsync -> os.replace, so a crash at any byte leaves
either the old file or the new one — never a torn hybrid.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.lint import (Finding, Module, Rule, call_name,
                                 terminal_name)
from repro_torch.analysis.rules import register

# evidence that a function journals: any call through an attr chain
# containing "wal"/"journal" (self.wal.append, wal.append, log.journal)
_JOURNAL_TOKENS = ("wal", "journal")


def _is_journal_call(call: ast.Call) -> bool:
    name = call_name(call).lower()
    return any(tok in name.split(".") for tok in _JOURNAL_TOKENS)


@register
class WalBeforeApplyRule(Rule):
    id = "REPRO-W301"
    family = "durability"
    scopes = ("service",)
    description = ("apply_op() must be dominated by a WAL append in the "
                   "same function (journal-then-apply)")
    rationale = ("The recovery contract: an op that applied but was "
                 "never journaled is lost on crash and replay diverges "
                 "from live state.  The shared live/replay apply path "
                 "is the one legitimate exception — baseline it with "
                 "the call-graph justification.")

    def check(self, mod: Module) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            journaled_lines: List[int] = []
            applies: List[ast.Call] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if mod.enclosing_function(node) is not fn:
                    continue    # nested functions audit themselves
                if _is_journal_call(node):
                    journaled_lines.append(node.lineno)
                elif terminal_name(node) == "apply_op":
                    applies.append(node)
            for call in applies:
                if not any(ln <= call.lineno for ln in journaled_lines):
                    yield self.finding(
                        mod, call,
                        f"apply_op() in {fn.name}() without a preceding "
                        "WAL append — journal-then-apply, or baseline "
                        "the shared replay path with its justification")


# write sites that must be atomic+durable in checkpoint/journal code
_WRITE_TERMINALS = {"savez", "savez_compressed", "dump", "write_text",
                    "write_bytes"}


def _open_mode(call: ast.Call) -> Optional[str]:
    if call_name(call) != "open":
        return None
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return mode if isinstance(mode, str) else None


@register
class AtomicWriteRule(Rule):
    id = "REPRO-W302"
    family = "durability"
    scopes = ("service", "studybank.py", "checkpoint.py", "optimizer.py")
    description = ("checkpoint/journal file writes must go through "
                   "flush + fsync + os.replace (atomic rename)")
    rationale = ("A crash mid-write without the tmp/fsync/replace idiom "
                 "leaves a torn file that recovery then trusts.  The "
                 "WAL's torn-tail truncation only protects the journal "
                 "itself; snapshots and configs must be "
                 "all-or-nothing.")

    def check(self, mod: Module) -> Iterable[Finding]:
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            has_fsync = has_replace = delegates = False
            sites: List[ast.Call] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if mod.enclosing_function(node) is not fn:
                    continue    # nested functions audit themselves
                term = terminal_name(node)
                name = call_name(node)
                if term == "fsync":
                    has_fsync = True
                elif term == "replace" or name == "os.replace":
                    has_replace = True
                elif "atomic" in term.lower():
                    delegates = True    # routed through an atomic helper
                mode = _open_mode(node)
                if mode in ("w", "wb", "w+", "wb+"):
                    sites.append(node)
                elif (term in _WRITE_TERMINALS
                      and name.split(".", 1)[0] in ("np", "numpy", "json")
                      and term != "write_text"):
                    sites.append(node)
                elif term in ("write_text", "write_bytes"):
                    sites.append(node)
            if delegates or not sites:
                continue
            if has_fsync and has_replace:
                continue
            missing = [w for w, ok in
                       (("fsync", has_fsync), ("os.replace", has_replace))
                       if not ok]
            for site in sites:
                yield self.finding(
                    mod, site,
                    f"durable write without {' + '.join(missing)} — use "
                    "write-tmp -> flush -> fsync -> os.replace so a "
                    "crash never publishes a torn file")
