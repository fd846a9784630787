"""R6 — leader returns an aliased slot buffer in the thread fan-out.

In the hybrid thread collectives (``ThreadCommSlave._fan_in_out``) each
thread deposits a VIEW of its caller's array into the shared ``slots``;
the ``leader`` closure's return value becomes the shared ``result``
that every thread then reads. A leader that returns ``slots[i]``
without detaching (``_detach`` / ``.copy()`` / ``dict()`` / ``list()``)
hands every thread a buffer aliasing thread *i*'s input — the next
in-place merge corrupts a sibling's data (the aliased-buffer hazard
documented on ``_detach``).

The rule inspects functions named ``leader`` whose first parameter is
the slots list, and flags returns of raw subscripts of it (directly or
through a simple local name). Slots that arrive pre-detached (the
pairwise tree reduce detaches slot 0) carry inline suppressions citing
that invariant.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity
from ytk_mp4j_tpu_torch.analysis.rules.common import walk_pruned

_DETACHERS = {"_detach", "copy", "deepcopy", "dict", "list", "array",
              "asarray", "ascontiguousarray", "_copied_map"}


def _subscripts_of(expr: ast.AST, param: str) -> bool:
    """True when ``expr`` is (or chooses between) raw ``param[...]``
    subscripts — ``slots[0]`` or ``slots[a] if c else slots[b]``."""
    if isinstance(expr, ast.Subscript):
        return isinstance(expr.value, ast.Name) and expr.value.id == param
    if isinstance(expr, ast.IfExp):
        return (_subscripts_of(expr.body, param)
                or _subscripts_of(expr.orelse, param))
    return False


class R6AliasedLeaderResult(Rule):
    rule_id = "R6"
    severity = Severity.WARNING
    title = "aliased slot returned from leader"
    description = ("fan-out leader returns slots[i] without _detach/copy "
                   "— result aliases one thread's input buffer")
    example = """\
class ThreadComm:
    def allreduce(self):
        def leader(slots):
            acc = slots[0]      # alias into another thread's slot
            return acc
"""

    def visit_FunctionDef(self, node):           # noqa: N802
        if node.name == "leader" and node.args.args:
            self._check_leader(node, node.args.args[0].arg)
        self.generic_visit_scoped(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_leader(self, node: ast.FunctionDef, param: str):
        # names bound to raw slot subscripts (and never rebound to
        # anything detached)
        aliased: set[str] = set()
        for n in walk_pruned(node.body):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                name = n.targets[0].id
                if _subscripts_of(n.value, param) or (
                        isinstance(n.value, ast.Name)
                        and n.value.id in aliased):
                    aliased.add(name)
                else:
                    aliased.discard(name)
        for n in walk_pruned(node.body):
            if not isinstance(n, ast.Return) or n.value is None:
                continue
            v = n.value
            if isinstance(v, ast.Call) and call_name(v) in _DETACHERS:
                continue
            if _subscripts_of(v, param) or (
                    isinstance(v, ast.Name) and v.id in aliased):
                self.report(n, (
                    f"leader returns a raw '{param}[...]' slot — the "
                    f"shared result aliases one thread's input view; "
                    f"detach with _detach()/copy() (or suppress citing "
                    f"the invariant that already detached it)"))
