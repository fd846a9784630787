"""R7 — mutable default arguments and module-level mutable state.

Two shapes:

- a mutable default (``def f(x, acc=[])``), anywhere: the default is
  created once and shared across calls — in a comm stack that means
  shared across ranks/threads of a process, a cross-rank state leak.
- a module-level ``{}`` / ``[]`` / ``set()`` in ``comm/`` / ``ops/`` /
  ``transport/`` that the module itself mutates: process-global state
  shared by every job and thread in the process. Read-only lookup
  tables are fine and not flagged; deliberate process-wide caches carry
  inline suppressions naming their reset path.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity

_MUTABLE_CTORS = {"list", "dict", "set", "defaultdict", "Counter",
                  "OrderedDict", "deque", "bytearray"}
_MUTATORS = {"append", "extend", "insert", "clear", "update",
             "setdefault", "pop", "popitem", "remove", "add", "discard",
             "appendleft", "sort"}
_STATE_DIRS = ("comm", "ops", "transport")


def _is_mutable_literal(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return isinstance(expr, ast.Call) and call_name(expr) in _MUTABLE_CTORS


class R7MutableState(Rule):
    rule_id = "R7"
    severity = Severity.ERROR
    title = "shared mutable state"
    description = ("mutable default argument, or module-level mutable "
                   "container mutated at runtime in comm/ops/transport")
    example = """\
def accumulate(x, acc=[], *, opts={}):
    acc.append(x)               # shared across EVERY call
"""

    # -- mutable defaults ----------------------------------------------
    def visit_FunctionDef(self, node):           # noqa: N802
        args = node.args
        for arg, default in list(zip(reversed(args.posonlyargs + args.args),
                                     reversed(args.defaults))) + \
                list(zip(args.kwonlyargs, args.kw_defaults)):
            if default is not None and _is_mutable_literal(default):
                self.report(default, (
                    f"mutable default for parameter '{arg.arg}' is "
                    f"created once and shared across every call (and "
                    f"every rank/thread in the process)"))
        self.generic_visit_scoped(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- module-level mutated containers -------------------------------
    def visit_Module(self, node: ast.Module):    # noqa: N802
        if self.ctx.in_dirs(*_STATE_DIRS):
            candidates: dict[str, ast.stmt] = {}
            for stmt in node.body:
                target = None
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    target, value = stmt.targets[0].id, stmt.value
                elif isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name) \
                        and stmt.value is not None:
                    target, value = stmt.target.id, stmt.value
                if target and _is_mutable_literal(value):
                    candidates[target] = stmt
            for name in self._mutated_names(node, set(candidates)):
                stmt = candidates[name]
                self.report(stmt, (
                    f"module-level mutable '{name}' is mutated at "
                    f"runtime — process-global state shared across "
                    f"jobs and threads; prefer instance state (or "
                    f"suppress naming the reset path)"))
        self.generic_visit(node)

    @staticmethod
    def _mutated_names(tree: ast.Module, names: set[str]) -> list[str]:
        hit: set[str] = set()
        for n in ast.walk(tree):
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = (n.targets if isinstance(n, ast.Assign)
                           else [n.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in names:
                        hit.add(t.value.id)
            elif isinstance(n, ast.Delete):
                for t in n.targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in names:
                        hit.add(t.value.id)
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _MUTATORS \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id in names:
                hit.add(n.func.value.id)
        return sorted(hit)
