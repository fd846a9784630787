"""R3 — thread-group shared state mutated outside the group lock.

``_ThreadGroup`` instances (received as ``self._g`` / ``group`` /
``g``) carry state shared by every thread of a process: ``slots``,
``result``, ``max_code``, ``pending_closes``, ``closed``. Mutating any
of these outside ``with group.lock`` is a data race — unless the region
is barrier-delimited (every thread passes a barrier between the write
and any cross-thread read), which a static pass cannot prove; those
regions carry inline ``# mp4j-lint: disable=R3`` suppressions stating
the barrier argument.

The rule tracks simple local aliases (``slots = self._g.slots`` then
``slots[i] = ...``) and mutating method calls (``.append`` /
``.update`` / ...) as well as direct attribute / subscript stores.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, attr_chain
from ytk_mp4j_tpu_torch.analysis.report import Severity

_SHARED = {"slots", "result", "max_code", "pending_closes", "closed"}
_GROUP_NAMES = {"_g", "g", "group"}
_MUTATORS = {"append", "extend", "insert", "clear", "update",
             "setdefault", "pop", "remove", "add"}


def _shared_chain(node: ast.AST) -> str | None:
    """``self._g.slots`` -> ``"slots"`` when the receiver is a thread
    group; None otherwise."""
    chain = attr_chain(node)
    if chain and len(chain) >= 2 and chain[-1] in _SHARED \
            and chain[-2] in _GROUP_NAMES:
        return chain[-1]
    return None


class R3SharedStateOutsideLock(Rule):
    rule_id = "R3"
    severity = Severity.ERROR
    title = "thread-group state outside lock"
    description = ("_ThreadGroup shared state (slots/result/max_code/...) "
                   "mutated outside the group lock or a documented "
                   "barrier region")
    example = """\
class ThreadAllreduce:
    def publish(self, value):
        self._g.result = value          # outside `with self._g.lock`
"""

    def run(self, ctx):
        self._with_lock_depth = 0
        self._aliases: list[dict[str, str]] = []   # per-function
        return super().run(ctx)

    # -- structure tracking --------------------------------------------
    def visit_With(self, node: ast.With):        # noqa: N802
        locked = any(
            (chain := attr_chain(item.context_expr)) and "lock" in chain[-1]
            for item in node.items)
        if locked:
            self._with_lock_depth += 1
        self.generic_visit(node)
        if locked:
            self._with_lock_depth -= 1

    def visit_FunctionDef(self, node):           # noqa: N802
        self._aliases.append({})
        try:
            self.generic_visit_scoped(node)
        finally:
            self._aliases.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- mutation detection --------------------------------------------
    def _alias_of(self, name: str) -> str | None:
        for frame in reversed(self._aliases):
            if name in frame:
                return frame[name]
        return None

    def _target_shared(self, target: ast.AST) -> str | None:
        """Shared-state name mutated by storing to ``target``, if any."""
        if isinstance(target, ast.Attribute):
            return _shared_chain(target)
        if isinstance(target, ast.Subscript):
            base = target.value
            shared = _shared_chain(base)
            if shared:
                return shared
            if isinstance(base, ast.Name):
                return self._alias_of(base.id)
        return None

    def _flag(self, node: ast.AST, name: str, verb: str):
        if self._with_lock_depth == 0:
            self.report(node, (
                f"thread-group shared state '{name}' {verb} outside "
                f"'with group.lock' — data race unless the region is "
                f"barrier-delimited (suppress with the barrier argument "
                f"if it is)"))

    def visit_Assign(self, node: ast.Assign):    # noqa: N802
        for target in node.targets:
            shared = self._target_shared(target)
            if shared:
                self._flag(node, shared, "assigned")
            # record local aliases of shared containers
            if isinstance(target, ast.Name) and self._aliases:
                shared_src = _shared_chain(node.value)
                if shared_src:
                    self._aliases[-1][target.id] = shared_src
                else:
                    self._aliases[-1].pop(target.id, None)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):  # noqa: N802
        shared = self._target_shared(node.target)
        if shared:
            self._flag(node, shared, "updated")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):        # noqa: N802
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            base = node.func.value
            shared = _shared_chain(base)
            if not shared and isinstance(base, ast.Name):
                shared = self._alias_of(base.id)
            if shared:
                self._flag(node, shared, f"mutated via .{node.func.attr}()")
        self.generic_visit(node)
