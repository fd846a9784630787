"""R5 — bare ``except:`` and swallowed broad exceptions in comm paths.

Two shapes:

- ``except:`` with no type, anywhere: catches ``SystemExit`` /
  ``KeyboardInterrupt`` and hides protocol violations — in a collective
  this converts a crash (diagnosable) into a rank silently falling out
  of the schedule (deadlock for everyone else).
- ``except Exception: pass`` (broad type, body only pass/continue) in
  the comm hot paths (``comm/``, ``transport/``, ``ops/``): a transport
  or reduction error vanishes and the ranks drift apart. Narrow types
  (``except OSError: pass``) are accepted — swallowing a *specific*
  failure is a documented decision, swallowing everything is not.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, attr_chain
from ytk_mp4j_tpu_torch.analysis.report import Severity

_BROAD = {"Exception", "BaseException"}
_HOT_DIRS = ("comm", "transport", "ops")


def _is_noop_body(body) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass) or isinstance(stmt, ast.Continue):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue        # docstring / ellipsis
        return False
    return True


class R5SwallowedException(Rule):
    rule_id = "R5"
    severity = Severity.ERROR
    title = "swallowed exception in comm path"
    description = ("bare except (anywhere) or broad except with a no-op "
                   "body in comm/transport/ops hot paths")
    example = """\
def relay():
    try:
        forward()
    except:                     # bare: catches KeyboardInterrupt too
        raise RuntimeError("relay failed")
"""

    def visit_ExceptHandler(self, node: ast.ExceptHandler):  # noqa: N802
        if node.type is None:
            self.report(node, (
                "bare 'except:' catches everything including "
                "KeyboardInterrupt — name the failure being handled"))
        elif self.ctx.in_dirs(*_HOT_DIRS) and _is_noop_body(node.body):
            types = (node.type.elts if isinstance(node.type, ast.Tuple)
                     else [node.type])
            names = [chain[-1] for t in types if (chain := attr_chain(t))]
            if any(n in _BROAD for n in names):
                self.report(node, (
                    f"'except {'/'.join(names)}: pass' in a comm hot path "
                    f"swallows transport/reduction failures — ranks drift "
                    f"out of the collective schedule silently"))
        self.generic_visit(node)
