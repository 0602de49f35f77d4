"""Justified-findings baseline for repro-lint.

A baseline entry acknowledges ONE deliberate violation with a one-line
justification, e.g. the tuner's user-facing wall-clock result timing
(REPRO-D001 is about deadlines, not reporting).  Entries match findings
by ``(rule, path, stripped source line)`` — never by line *number* — so
unrelated edits above a justified line can't invalidate the baseline,
while editing the offending line itself (the thing the justification was
written about) correctly turns the entry stale and the finding live.

File format (``.repro-torch-lint-baseline`` at the repo root for the
port): JSON, hand-editable, stable key order::

    {"version": 1,
     "entries": [{"rule": "REPRO-D001",
                  "path": "src/repro_torch/core/tuner.py",
                  "content": "t0 = time.time()",
                  "note": "user-facing wall-clock result timing"}]}

Workflow: ``python -m repro_torch.analysis src/repro_torch
--write-baseline PATH`` emits entries (note = TODO) for every current
finding; justify each, commit
the file, and the lint passes while any NEW finding still fails.
Stale entries (matching nothing) are reported as warnings so dead
justifications get pruned, but never fail the run.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.analysis.lint import Finding

VERSION = 1


class Baseline:
    def __init__(self, entries: Optional[List[Dict[str, Any]]] = None):
        self.entries: List[Dict[str, Any]] = entries or []

    # ------------------------------------------------------------- io
    @classmethod
    def load(cls, path) -> "Baseline":
        data = json.loads(Path(path).read_text())
        if data.get("version") != VERSION:
            raise ValueError(
                f"baseline {path}: unsupported version "
                f"{data.get('version')!r} (expected {VERSION})")
        entries = data.get("entries", [])
        for e in entries:
            for key in ("rule", "path", "content"):
                if key not in e:
                    raise ValueError(
                        f"baseline {path}: entry missing {key!r}: {e}")
        return cls(entries)

    def save(self, path) -> None:
        data = {"version": VERSION, "entries": self.entries}
        Path(path).write_text(json.dumps(data, indent=1) + "\n")

    # ------------------------------------------------------- matching
    @staticmethod
    def _same_file(entry_path: str, finding_path: str) -> bool:
        """Suffix-tolerant path equality: the committed baseline stores
        repo-relative paths (``src/repro_torch/...``) but the engine may be
        handed absolute paths (tests, editors) — same file either way."""
        if entry_path == finding_path:
            return True
        return (finding_path.endswith("/" + entry_path)
                or entry_path.endswith("/" + finding_path))

    def match(self, f: Finding) -> Optional[int]:
        """Index of the first entry covering ``f``, or None.  An entry
        covers any number of identical offending lines in its file (a
        pattern duplicated in two branches needs one justification)."""
        for i, e in enumerate(self.entries):
            if (e["rule"] == f.rule and self._same_file(e["path"], f.path)
                    and e["content"] == f.content):
                return i
        return None

    @classmethod
    def from_findings(cls, findings, note: str = "TODO: justify"
                      ) -> "Baseline":
        seen = set()
        entries = []
        for f in findings:
            key = (f.rule, f.path, f.content)
            if key in seen:
                continue
            seen.add(key)
            entries.append({"rule": f.rule, "path": f.path,
                            "content": f.content, "note": note})
        return cls(entries)
