"""R11 — wall clock used for duration/deadline measurement.

The trace plane measures phases with ``time.perf_counter`` and the
watchdogs/deadlines run on ``time.monotonic``; ``time.time()``
is subject to NTP steps and slews, so a duration or deadline derived
from it can jump backwards, expire instantly, or never expire — the
exact failure mode is a recovery deadline firing spuriously mid-abort
(declaring a healthy rank dead) or a phase measurement going negative
in a merged trace. The rendezvous deadline in ``comm/master.py`` had
this bug until it was converted to ``monotonic``.

Wall clock remains CORRECT in two shapes, which stay quiet:

- **storage/formatting**: a timestamp written into an artifact or a
  log line (``{"wall_time": time.time()}``, ``time.localtime(now)``,
  ``now % 1`` millisecond formatting) is a point in time, not a
  measurement;
- **the trace anchor** (``obs/spans.py`` ``_epoch_wall``): exported
  Chrome-trace timestamps must be comparable ACROSS independently
  launched processes, which only the wall clock provides — spans are
  still *recorded* in perf_counter time and anchored once. This is
  arithmetic, so it fires, and it is the baselined sanctioned site.

Heuristic: in ``comm/``, ``obs/``, ``transport/`` a ``time.time()``
call (or bare ``time()`` when the module does ``from time import
time``) fires when its value enters add/subtract arithmetic or a
comparison — directly (``deadline - time.time()``, ``time.time() >
deadline``) or through a name assigned from it and used that way in
the same function scope (module-level names are tracked module-wide —
the spans anchor pattern — except in scopes that bind the same name
locally, which shadow rather than implicate it).
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule
from ytk_mp4j_tpu_torch.analysis.report import Finding, Severity

_ARITH_OPS = (ast.Add, ast.Sub)


def _is_wall_call(node: ast.AST, bare: bool) -> bool:
    """``time.time()``; or plain ``time()`` in a module that does
    ``from time import time``."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return (f.attr == "time" and isinstance(f.value, ast.Name)
                and f.value.id == "time")
    return bare and isinstance(f, ast.Name) and f.id == "time"


class R11WallClockDuration(Rule):
    rule_id = "R11"
    severity = Severity.ERROR
    title = "wall clock used for duration/deadline measurement"
    description = ("time.time() feeding duration/deadline arithmetic "
                   "is subject to NTP steps — phases must use "
                   "time.perf_counter and deadlines time.monotonic; "
                   "wall clock only at the sanctioned trace-anchor / "
                   "artifact-timestamp sites")
    example = """\
import time

def rendezvous(self):
    deadline = time.time() + self.timeout   # NTP step breaks this
    while time.time() < deadline:
        self.accept_one()
"""

    _MSG = ("wall-clock time.time() feeds duration/deadline "
            "arithmetic; use time.perf_counter (phases) or "
            "time.monotonic (deadlines) — NTP can step the wall "
            "clock mid-measurement")

    def run(self, ctx):
        self._bare = False
        # name-flow state, resolved after the walk: assignments
        # `x = time.time()` and the names that entered +/-/compare
        # expressions, keyed by enclosing scope; _local_binds tracks
        # every locally bound name (params + assignments) so a local
        # that SHADOWS a module-level name cannot implicate it
        self._assigns: list[tuple[str, str, ast.AST]] = []
        self._arith: dict[str, set[str]] = {}
        self._local_binds: dict[str, set[str]] = {}
        self._reported: set[int] = set()
        return super().run(ctx)

    def visit_Module(self, node):               # noqa: N802
        if not self.ctx.in_dirs("comm", "obs", "transport"):
            return
        self._bare = any(
            isinstance(n, ast.ImportFrom) and n.module == "time"
            and any(alias.name == "time" for alias in n.names)
            for n in ast.walk(node))
        self.generic_visit(node)
        # deferred name-flow findings: a wall-clock value that entered
        # arithmetic/comparison through its assigned name. A
        # module-level name counts in any scope that does NOT bind the
        # same name locally (the spans `_epoch_wall` anchor pattern);
        # a function-local assign counts only in its own scope.
        for name, qual, call in self._assigns:
            if qual == "<module>":
                hit = any(name in names
                          and (q == "<module>"
                               or name not in self._local_binds.get(
                                   q, ()))
                          for q, names in self._arith.items())
            else:
                hit = name in self._arith.get(qual, ())
            if hit:
                self.findings.append(Finding(
                    rule=self.rule_id, severity=self.severity,
                    path=self.ctx.path,
                    line=getattr(call, "lineno", 0),
                    col=getattr(call, "col_offset", 0) + 1,
                    message=self._MSG, context=qual))

    def _visit_def(self, node):
        self.scope.append(node.name)
        try:
            binds = self._local_binds.setdefault(self.qualname(), set())
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                binds.add(arg.arg)
            # every locally bound name shadows: plain/aug/ann assigns,
            # for targets, with ... as, walrus, unpacking, except-as
            # (pruned at nested defs — those have their own scope)
            stack = list(ast.iter_child_nodes(node))
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                if isinstance(n, ast.Name) and isinstance(n.ctx,
                                                          ast.Store):
                    binds.add(n.id)
                elif isinstance(n, ast.ExceptHandler) and n.name:
                    binds.add(n.name)
                stack.extend(ast.iter_child_nodes(n))
            self.generic_visit(node)
        finally:
            self.scope.pop()

    visit_FunctionDef = _visit_def              # noqa: N815
    visit_AsyncFunctionDef = _visit_def         # noqa: N815

    def visit_Lambda(self, node):               # noqa: N802
        # lambdas get a pseudo-scope: their body's arithmetic must not
        # key to the enclosing scope (a module-level lambda would key
        # to <module>, whose deferred branch never consults binds) and
        # their params must shadow like def params do. Lambdas sharing
        # an enclosing scope share the pseudo-scope — binds union, an
        # over-approximation in the quiet direction.
        self.scope.append("<lambda>")
        try:
            binds = self._local_binds.setdefault(self.qualname(), set())
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                binds.add(arg.arg)
            self.generic_visit(node)
        finally:
            self.scope.pop()

    def visit_Assign(self, node):               # noqa: N802
        if _is_wall_call(node.value, self._bare):
            qual = self.qualname()
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._assigns.append((tgt.id, qual, node.value))
        self.generic_visit(node)

    def visit_BinOp(self, node):                # noqa: N802
        if isinstance(node.op, _ARITH_OPS):
            self._note_expr(node)
        self.generic_visit(node)

    def visit_Compare(self, node):              # noqa: N802
        self._note_expr(node)
        self.generic_visit(node)

    def _note_expr(self, expr: ast.AST) -> None:
        names = self._arith.setdefault(self.qualname(), set())
        for n in self._operands(expr):
            if _is_wall_call(n, self._bare):
                if id(n) not in self._reported:   # nested BinOps
                    self._reported.add(id(n))
                    self.report(n, self._MSG)
            elif isinstance(n, ast.Name):
                names.add(n.id)

    @staticmethod
    def _operands(expr: ast.AST):
        """The expression's subtree, pruned at nested calls and
        f-strings: their INSIDES are not operands of this arithmetic
        (``time.strftime(...) + f"{ms}"`` is string formatting, not a
        measurement), while the call node itself still is one
        (``deadline - time.time()``). Arithmetic inside a pruned
        subtree is its own BinOp node and gets visited directly."""
        stack = [expr]
        while stack:
            n = stack.pop()
            yield n
            if n is not expr and isinstance(n, (ast.Call, ast.JoinedStr)):
                continue
            stack.extend(ast.iter_child_nodes(n))
