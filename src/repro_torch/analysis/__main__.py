"""CLI: ``python -m repro_torch.analysis [paths...]``, by default over
``src/repro_torch/``.

Exit codes: 0 = clean (every finding suppressed or baselined),
1 = unbaselined findings (or unparsable files), 2 = usage error.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.rules import all_rules


def _list_rules() -> str:
    lines = []
    for r in all_rules():
        lines.append(f"{r.id}  [{r.family}]  scopes={','.join(r.scopes)}")
        lines.append(f"    {r.description}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint for the PyTorch port: repo-specific "
                    "static analysis")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files/directories to lint (default: "
                         "src/repro_torch/)")
    ap.add_argument("--baseline", metavar="PATH", default=None,
                    help="justified-findings baseline file; matching "
                         "findings are suppressed")
    ap.add_argument("--write-baseline", metavar="PATH", default=None,
                    help="write every current finding as a baseline "
                         "entry (note=TODO) and exit 0")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0
    paths = args.paths or ["src/repro_torch/"]
    baseline = None
    if args.baseline:
        try:
            baseline = Baseline.load(args.baseline)
        except FileNotFoundError:
            print(f"baseline {args.baseline} not found", file=sys.stderr)
            return 2
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
    res = lint_paths(paths, baseline=baseline)

    if args.write_baseline:
        Baseline.from_findings(res.findings).save(args.write_baseline)
        print(f"wrote {len(res.findings)} finding(s) as baseline entries "
              f"to {args.write_baseline} — justify each note before "
              "committing")
        return 0

    if args.format == "json":
        print(json.dumps({
            "unbaselined": [vars(f) for f in res.unbaselined],
            "baselined": [vars(f) for f in res.baselined],
            "stale_baseline_entries": res.stale,
            "errors": res.errors,
        }, indent=1))
    else:
        for f in res.unbaselined:
            print(f.format())
        for e in res.errors:
            print(f"error: {e}", file=sys.stderr)
        for e in res.stale:
            print(f"warning: stale baseline entry (nothing matches): "
                  f"{e['rule']} {e['path']} {e['content']!r}",
                  file=sys.stderr)
        print(f"repro-lint: {len(res.unbaselined)} finding(s), "
              f"{len(res.baselined)} baselined, {len(res.stale)} stale "
              f"baseline entr{'y' if len(res.stale) == 1 else 'ies'}")
    return 1 if (res.unbaselined or res.errors) else 0


if __name__ == "__main__":
    sys.exit(main())
