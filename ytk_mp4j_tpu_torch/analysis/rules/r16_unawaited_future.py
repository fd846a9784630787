"""R16 — a CollectiveFuture never awaited before a collective boundary.

The nonblocking API hands out :class:`CollectiveFuture`
handles whose buffers the scheduler owns until ``wait()`` (or
``wait_all()``) resolves them. A future that is still un-awaited when
the SAME comm object enters a blocking collective, a ``barrier()``, or
``close()`` is a latent hazard: the runtime drains outstanding work at
those boundaries (so the program *happens* to be correct), but the
caller is reading or reusing a buffer whose completion it never
observed — and on backends without the drain (or after a refactor that
reorders the calls) that becomes a data race on the payload buffer.
The fix is one of: ``f.wait()`` before the boundary, ``comm.wait_all()``
(which this rule recognizes), or not holding the future at all.

Heuristic (function-local, statement order): an assignment
``f = comm.iallreduce(...)`` (any ``i*`` nonblocking method) opens a
tracked future; ``f.wait()`` / ``f.result()`` / ``f.exception()``
closes it, as does ``comm.wait_all()`` on the same receiver — and ANY
other use of ``f`` (passed to a call, stored, returned) conservatively
closes it too (the future escaped; its awaiting is someone else's
contract). A call to a blocking collective / ``barrier`` / ``close``
on the same receiver while a tracked future is open fires the rule.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import (
    Rule, attr_chain, call_name, receiver_chain)
from ytk_mp4j_tpu_torch.analysis.report import Severity

I_METHODS = frozenset({
    "iallreduce", "ireduce_scatter", "iallgather", "igather",
    "iallreduce_map",
})
_AWAITS = frozenset({"wait", "result", "exception"})
_BLOCKING = frozenset({
    "allreduce_array", "reduce_array", "broadcast_array",
    "allgather_array", "gather_array", "scatter_array",
    "reduce_scatter_array", "allreduce_map", "allreduce_map_multi",
    "reduce_map", "broadcast_map", "gather_map", "allgather_map",
    "scatter_map", "reduce_scatter_map", "barrier", "close",
})


class R16UnawaitedFuture(Rule):
    rule_id = "R16"
    severity = Severity.ERROR
    title = "un-awaited CollectiveFuture crosses a collective boundary"
    description = ("a future from an i* nonblocking collective is "
                   "never awaited before a blocking collective, "
                   "barrier, or close on the same comm")
    example = """\
def step(comm, x):
    f = comm.iallreduce(x)
    comm.barrier()              # f never awaited before the boundary
"""

    def visit_FunctionDef(self, node):          # noqa: N802
        self._check_function(node)
        self.generic_visit_scoped(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # noqa: N815

    @classmethod
    def _iter_own(cls, node: ast.AST):
        """Pre-order (source-order) walk of a function's OWN body —
        nested defs/lambdas analyze on their own visit."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda,
                                  ast.ClassDef)):
                continue
            yield child
            yield from cls._iter_own(child)

    def _check_function(self, fn: ast.AST) -> None:
        # futures open in THIS function body: name -> (line, receiver)
        open_futs: dict[str, tuple[int, tuple]] = {}
        self.scope.append(getattr(fn, "name", "<anon>"))
        try:
            for stmt in self._iter_own(fn):
                if isinstance(stmt, ast.Assign):
                    self._on_assign(stmt, open_futs)
                elif isinstance(stmt, ast.Call):
                    self._on_call(stmt, open_futs)
        finally:
            self.scope.pop()

    def _on_assign(self, node: ast.Assign, open_futs) -> None:
        if len(node.targets) != 1 \
                or not isinstance(node.targets[0], ast.Name):
            return
        call = node.value
        if isinstance(call, ast.Call) \
                and call_name(call) in I_METHODS:
            recv = receiver_chain(call)
            if recv is not None:
                open_futs[node.targets[0].id] = (node.lineno,
                                                 tuple(recv))

    def _on_call(self, call: ast.Call, open_futs) -> None:
        name = call_name(call)
        # f.wait()/result()/exception() closes the future
        if name in _AWAITS and isinstance(call.func, ast.Attribute) \
                and isinstance(call.func.value, ast.Name):
            open_futs.pop(call.func.value.id, None)
            return
        # comm.wait_all() is the collective-boundary drain: closes
        # every future opened on the same receiver
        if name == "wait_all":
            recv = receiver_chain(call)
            for f, (_ln, r) in list(open_futs.items()):
                if recv is None or tuple(recv) == r:
                    open_futs.pop(f, None)
            return
        # any OTHER use of a tracked future (argument, container,
        # attribute base) closes it conservatively — it escaped
        for arg in ast.walk(call):
            if isinstance(arg, ast.Name) and arg.id in open_futs \
                    and arg is not call.func:
                open_futs.pop(arg.id, None)
        if name in _BLOCKING:
            recv = receiver_chain(call)
            if recv is None:
                return
            for f, (ln, r) in list(open_futs.items()):
                if tuple(recv) == r:
                    self.report(call, (
                        f"future '{f}' (line {ln}) is never awaited "
                        f"before this blocking '{name}' on the same "
                        f"comm: call .wait() or "
                        f"{'.'.join(recv)}.wait_all() first, or the "
                        "buffer's completion is unobserved"))
                    open_futs.pop(f, None)
