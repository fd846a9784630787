"""mp4j-lint — a collective-protocol static analyzer for the comm stack.

Mismatched collective schedules across ranks (a rank-dependent branch
that skips an allreduce, a dtype disagreement between the two ends of a
halving step, a blocking socket with no timeout) produce silent
deadlocks that no single-process unit test catches. This package is an
AST-based rule engine over the repo's own idioms — the Python analogue
of the protocol checkers production MPI/NCCL stacks ship.

Pieces:

- :mod:`~ytk_mp4j_tpu_torch.analysis.engine` — visitor framework and the
  two-pass driver (per-file rules + whole-program
  :class:`~ytk_mp4j_tpu_torch.analysis.engine.ProgramRule` instances);
- :mod:`~ytk_mp4j_tpu_torch.analysis.callgraph` — package index +
  conservative call graph;
- :mod:`~ytk_mp4j_tpu_torch.analysis.locks` — lock discovery, held-set
  propagation and the job-wide lock-order graph the R19-R21
  concurrency rules (and ``mp4j-lint graph``) ride;
- :mod:`~ytk_mp4j_tpu_torch.analysis.rules` — one module per rule (R1..R21);
- :mod:`~ytk_mp4j_tpu_torch.analysis.report` — findings with file:line and
  severity;
- :mod:`~ytk_mp4j_tpu_torch.analysis.baseline` — the committed suppression
  file ``baseline.toml`` (stale entries are ``B001`` findings in the
  tier-1 gate's ``--strict`` mode);
- :mod:`~ytk_mp4j_tpu_torch.analysis.cli` — the ``mp4j-lint`` entry point
  (also ``python -m ytk_mp4j_tpu_torch.analysis``).
"""

from ytk_mp4j_tpu_torch.analysis.engine import Engine, LintResult
from ytk_mp4j_tpu_torch.analysis.report import Finding, Severity

__all__ = ["Engine", "LintResult", "Finding", "Severity", "lint_paths"]


def lint_paths(paths, baseline_path=None):
    """Lint ``paths`` with all rules and the committed baseline (or
    ``baseline_path``); returns a :class:`LintResult`."""
    import os

    from ytk_mp4j_tpu_torch.analysis import baseline as baseline_mod
    from ytk_mp4j_tpu_torch.analysis.cli import DEFAULT_BASELINE

    if baseline_path is None:
        baseline_path = DEFAULT_BASELINE
    bl = (baseline_mod.load(baseline_path)
          if os.path.exists(baseline_path) else None)
    return Engine(baseline=bl).lint_paths(paths)
