"""repro_torch.analysis: the port's static analysis and runtime sanitizers.

The counterpart of ``repro.analysis``; it imports nothing of the JAX
package.

  * ``python -m repro_torch.analysis src/repro_torch --baseline
    .repro-torch-lint-baseline`` — the port's lint (stdlib-only, no torch
    import): the reference's determinism, concurrency and durability
    rules, and the eager-PyTorch device rules REPRO-T101..T103.
  * ``repro_torch.analysis.sanitizers`` — ``no_retrace`` / ``no_transfer``
    / ``assert_holds`` runtime guards and the sanctioned ``to_host`` /
    ``to_device`` crossings (imported lazily; they need torch).
  * ``python -m repro_torch.analysis.smoke [--device cpu]`` — warm bank
    asks under both guards.

See ``docs/torch_analysis.md`` for the rule catalog and workflow.
"""
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.lint import (Finding, LintResult, Module, Rule,
                                       lint_paths)

__all__ = ["Baseline", "Finding", "LintResult", "Module", "Rule",
           "lint_paths"]
