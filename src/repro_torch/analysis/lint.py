"""repro-lint for the PyTorch port: AST-driven, repo-specific static analysis.

The port's own copy of ``repro.analysis.lint`` (the port imports nothing of
the JAX package): the engine, the ``# repro: noqa`` syntax and the baseline
format are the reference's.  The repo's strongest properties are
*invariants*, not features — bit-identical crash replay, zero-retrace
steady-state serving, monotonic-deadline fault semantics.  Each rule in
``repro_torch.analysis.rules`` encodes one of those invariants at the line
level, so a regression is flagged on the push that introduces it instead
of surfacing as a flaky CI failure months later.

Engine pieces (stdlib-only — the lint needs no torch/numpy):

  * ``Module``: one parsed source file + parent links + per-line noqa.
  * ``Rule``: plugin base class; subclasses register via
    ``rules.register`` and scope themselves to directory/file tokens.
  * suppressions: ``# repro: noqa RULE-ID[,RULE-ID]`` on the offending
    line (bare ``# repro: noqa`` suppresses every rule on that line).
  * baseline: a JSON file of *justified* findings (see ``baseline.py``)
    matched by (rule, path, stripped source line) so line-number churn
    never invalidates an entry.

Exit contract of the CLI (``python -m repro_torch.analysis``): 0 when every
finding is suppressed or baselined, 1 otherwise.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

NOQA_RE = re.compile(r"#\s*repro:\s*noqa\b[:\s]*([A-Z0-9\-, ]*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str           # as passed to the engine (posix separators)
    line: int
    col: int
    message: str
    content: str        # stripped source line, the baseline match key

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


class Module:
    """One parsed file: tree + parent links + noqa table."""

    def __init__(self, path: str, src: str):
        self.path = str(Path(path).as_posix())
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # line -> set of suppressed rule ids ({"*"} = all)
        self.noqa: Dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = NOQA_RE.search(text)
            if m:
                ids = {s.strip() for s in m.group(1).replace(",", " ").split()
                       if s.strip()}
                self.noqa[i] = ids or {"*"}

    # ----------------------------------------------------------- helpers
    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule_id: str, lineno: int) -> bool:
        ids = self.noqa.get(lineno)
        return bool(ids) and ("*" in ids or rule_id in ids)

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_function(self, node: ast.AST):
        return self.enclosing(
            node, (ast.FunctionDef, ast.AsyncFunctionDef))


def dotted_name(node: ast.AST) -> str:
    """``np.random.default_rng`` for the func of a Call (best effort)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(dotted_name(node.func) + "()")
    return ".".join(reversed(parts))


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def terminal_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


class Rule:
    """Base class for lint rules.  Subclasses set the class attrs and
    implement ``check``; ``scopes`` holds directory tokens (``"core"``,
    ``"service"``) and/or file names (``"studybank.py"``) — a rule only
    runs on files under a matching directory or with a matching name, so
    fixtures under ``tmp/core/x.py`` exercise the same scoping as the
    real tree."""

    id: str = ""
    family: str = ""
    scopes: Tuple[str, ...] = ()
    description: str = ""
    rationale: str = ""

    def applies(self, path: str) -> bool:
        if not self.scopes:
            return True
        parts = Path(path).parts
        name = Path(path).name
        return any(tok in parts or tok == name for tok in self.scopes)

    def check(self, mod: Module) -> Iterable[Finding]:
        raise NotImplementedError

    # ----------------------------------------------------------- helper
    def finding(self, mod: Module, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(self.id, mod.path, line, col, message,
                       mod.line_text(line))


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]          # all, after noqa suppression
    unbaselined: List[Finding]       # findings with no baseline entry
    baselined: List[Finding]
    stale: List[dict]                # baseline entries matching nothing
    errors: List[str]                # unparsable files

    @property
    def ok(self) -> bool:
        return not self.unbaselined and not self.errors


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            out.extend(str(f.as_posix()) for f in sorted(pp.rglob("*.py")))
        elif pp.suffix == ".py":
            out.append(str(pp.as_posix()))
    return out


def lint_paths(paths: Sequence[str], rules: Optional[Sequence[Rule]] = None,
               baseline=None) -> LintResult:
    """Run ``rules`` (default: every registered rule) over ``paths``.

    ``baseline`` is a ``repro_torch.analysis.baseline.Baseline`` (or None).
    """
    if rules is None:
        from repro_torch.analysis.rules import all_rules
        rules = all_rules()
    findings: List[Finding] = []
    errors: List[str] = []
    for fpath in iter_py_files(paths):
        try:
            mod = Module(fpath, Path(fpath).read_text())
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{fpath}: {type(e).__name__}: {e}")
            continue
        for rule in rules:
            if not rule.applies(fpath):
                continue
            for f in rule.check(mod):
                if not mod.suppressed(f.rule, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if baseline is None:
        return LintResult(findings, list(findings), [], [], errors)
    kept, suppressed = [], []
    used = set()
    for f in findings:
        idx = baseline.match(f)
        if idx is None:
            kept.append(f)
        else:
            suppressed.append(f)
            used.add(idx)
    stale = [e for i, e in enumerate(baseline.entries) if i not in used]
    return LintResult(findings, kept, suppressed, stale, errors)
