"""R26 — an in-loop ``i*`` submit awaited with no compute between.

The whole point of the nonblocking API — and of the trainer
overlap loops built on it — is that the exchange runs WHILE
the caller computes something independent. A loop body that submits a
nonblocking collective and immediately awaits it::

    for g in grads:
        f = comm.iallreduce(g)
        f.wait()

pays the submission machinery (future allocation, queue handoff,
progression-thread wakeup) and buys zero overlap — it is strictly
slower than the blocking twin, and usually indicates the author MEANT
to overlap and lost the compute statement in a refactor. The fix is
one of: move the next step's independent compute between submit and
await, batch several submits before one ``wait_all()`` drain (the
engine pipelines them), or call the blocking collective.

Heuristic (loop-body statement order, one loop at a time): an
assignment ``f = comm.i*(...)`` among a loop's DIRECT statements opens
a "clean" future; a later ``f.wait()`` / ``f.result()`` — or a
``comm.wait_all()`` — reached while the future is still clean fires
the rule. ANY other statement (including compound statements, whose
bodies are not inspected) counts as compute and marks every open
future dirty — conservative in the non-firing direction, so the rule
only speaks when the iteration provably interleaves nothing. Nested
loops are checked on their own visit.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import (
    Rule, call_name, receiver_chain)
from ytk_mp4j_tpu_torch.analysis.report import Severity
from ytk_mp4j_tpu_torch.analysis.rules.r16_unawaited_future import I_METHODS

_AWAITS = frozenset({"wait", "result"})


class R26ImmediateAwait(Rule):
    rule_id = "R26"
    severity = Severity.WARNING
    title = "in-loop i* submit awaited with no intervening compute"
    description = (
        "a nonblocking collective submitted inside a loop is awaited "
        "in the same iteration with no compute statement in between: "
        "the overlap is defeated — interleave independent compute, "
        "batch submits before one wait_all(), or use the blocking "
        "twin")
    example = """\
def epoch(comm, grads):
    for g in grads:
        f = comm.iallreduce(g)
        f.wait()
"""

    def visit_For(self, node):              # noqa: N802
        self._check_loop(node)
        self.generic_visit(node)

    visit_AsyncFor = visit_For              # noqa: N815

    def visit_While(self, node):            # noqa: N802
        self._check_loop(node)
        self.generic_visit(node)

    @staticmethod
    def _submit_of(stmt: ast.stmt):
        """``f = comm.i*(...)`` -> (name, call, receiver) else None."""
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            return None
        call = stmt.value
        if not isinstance(call, ast.Call) \
                or call_name(call) not in I_METHODS:
            return None
        recv = receiver_chain(call)
        return (stmt.targets[0].id, call,
                tuple(recv) if recv else None)

    @staticmethod
    def _await_of(stmt: ast.stmt):
        """``f.wait()`` / ``r = f.result()`` -> ("future", f, call);
        ``comm.wait_all()`` -> ("all", receiver, call); else None."""
        call = None
        if isinstance(stmt, ast.Expr):
            call = stmt.value
        elif isinstance(stmt, ast.Assign):
            call = stmt.value
        if not isinstance(call, ast.Call):
            return None
        name = call_name(call)
        if name in _AWAITS and isinstance(call.func, ast.Attribute) \
                and isinstance(call.func.value, ast.Name):
            return "future", call.func.value.id, call
        if name == "wait_all":
            recv = receiver_chain(call)
            return "all", tuple(recv) if recv else None, call
        return None

    def _check_loop(self, loop: ast.AST) -> None:
        # clean: futures submitted this iteration with NO compute
        # statement since — name -> (submit line, receiver)
        clean: dict[str, tuple[int, tuple | None]] = {}
        for stmt in loop.body:
            sub = self._submit_of(stmt)
            if sub is not None:
                name, _call, recv = sub
                clean[name] = (stmt.lineno, recv)
                continue
            aw = self._await_of(stmt)
            if aw is None:
                # compute: every open submit earned its overlap
                clean.clear()
                continue
            kind, key, call = aw
            if kind == "future":
                hit = clean.pop(key, None)
                if hit is not None:
                    self.report(call, (
                        f"future '{key}' (line {hit[0]}) is awaited "
                        f"with no compute since its submit — the "
                        f"overlap is defeated; interleave compute or "
                        f"use the blocking twin"))
                # an await of a dirty future blocks but computes
                # nothing: other clean futures stay clean
            else:
                drained = [(f, ln) for f, (ln, recv) in clean.items()
                           if key is None or recv is None
                           or recv == key]
                for f, _ln in drained:
                    clean.pop(f)
                if len(drained) == 1:
                    # a LONE submit drained immediately is pointless;
                    # several batched submits pipeline against each
                    # other (the engine's k-fold amortization) and
                    # pass
                    f, ln = drained[0]
                    self.report(call, (
                        f"future '{f}' (line {ln}) is drained by "
                        f"wait_all() with no compute since its "
                        f"submit — the overlap is defeated; "
                        f"interleave compute or use the blocking "
                        f"twin"))
