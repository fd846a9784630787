"""R2 — blocking socket/Channel operation with no timeout and no
failure handling.

A ``recv`` / ``recv_into`` / ``accept`` / ``sendall`` on a socket or
``Channel`` with no timeout configured and no enclosing handler turns a
dead peer into a silent, undiagnosable hang (the hazard class the
paper's fail-stop model accepts only at explicitly documented points).

A call escapes when either:

- it sits inside a ``try`` whose handlers catch ``socket.timeout`` /
  ``TimeoutError`` / ``OSError`` / ``Mp4jError`` / ``Exception`` (the
  site deals with transport failure), or
- the same function configured a timeout on the same receiver earlier
  (``x.settimeout(...)`` / ``x.set_timeout(...)`` with a non-``None``
  argument).

Deliberately unbounded waits (the reference's fail-stop barrier) carry
inline suppressions stating that contract.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import (
    Rule, attr_chain, call_name, receiver_chain)
from ytk_mp4j_tpu_torch.analysis.report import Severity

_BLOCKING = {"recv", "recv_into", "accept", "sendall"}
_HANDLED = {"timeout", "TimeoutError", "OSError", "ConnectionError",
            "Mp4jError", "Exception", "BaseException"}
_TIMEOUT_SETTERS = {"settimeout", "set_timeout"}


def _handler_names(handler: ast.ExceptHandler):
    if handler.type is None:        # bare except catches everything
        yield "BaseException"
        return
    types = (handler.type.elts
             if isinstance(handler.type, ast.Tuple) else [handler.type])
    for t in types:
        chain = attr_chain(t)
        if chain:
            yield chain[-1]


class R2UnboundedSocketOp(Rule):
    rule_id = "R2"
    severity = Severity.WARNING
    title = "unbounded socket operation"
    description = ("socket/Channel recv/accept/sendall without a timeout "
                   "or enclosing transport-failure handling")
    example = """\
class Puller:
    def pull(self):
        return self.sock.recv(1024)     # no timeout, no handler
"""

    def run(self, ctx):
        self._try_stack: list[ast.Try] = []
        self._func_stack: list[dict] = []    # per-function state
        return super().run(ctx)

    # -- structure tracking --------------------------------------------
    def visit_Try(self, node: ast.Try):      # noqa: N802
        # only the `body` is protected by the handlers; visit children
        # with the try on the stack for body, off the stack elsewhere
        self._try_stack.append(node)
        for stmt in node.body:
            self.visit(stmt)
        self._try_stack.pop()
        for part in (node.handlers, node.orelse, node.finalbody):
            for stmt in part:
                self.visit(stmt)

    def visit_FunctionDef(self, node):       # noqa: N802
        self._func_stack.append({"timeouts": []})
        try:
            self.generic_visit_scoped(node)
        finally:
            self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- the check ------------------------------------------------------
    def visit_Call(self, node: ast.Call):    # noqa: N802
        name = call_name(node)
        if name in _TIMEOUT_SETTERS and self._func_stack:
            arg = node.args[0] if node.args else None
            is_none = isinstance(arg, ast.Constant) and arg.value is None
            if not is_none:
                self._func_stack[-1]["timeouts"].append(
                    (receiver_chain(node), node.lineno))
        elif name in _BLOCKING and isinstance(node.func, ast.Attribute):
            if not self._escapes(node):
                self.report(node, (
                    f"blocking .{name}() with no timeout configured and "
                    f"no transport-failure handler: a dead peer hangs "
                    f"this call forever"))
        self.generic_visit(node)

    def _escapes(self, node: ast.Call) -> bool:
        recv = receiver_chain(node)
        if recv == ["self"]:
            # a method delegating to the object's OWN blocking wrapper
            # (Channel.recv_array -> self.recv()): the timeout
            # discipline is audited inside the wrapper, not at every
            # internal call site
            return True
        for t in self._try_stack:
            for h in t.handlers:
                if any(n in _HANDLED for n in _handler_names(h)):
                    return True
        if self._func_stack:
            for chain, lineno in self._func_stack[-1]["timeouts"]:
                if lineno > node.lineno:
                    continue
                # receiver-aware when both chains resolve; a computed
                # receiver (e.g. self._channel(p).recv()) matches any
                # earlier timeout in the function
                if recv is None or chain is None or chain == recv:
                    return True
        return False
