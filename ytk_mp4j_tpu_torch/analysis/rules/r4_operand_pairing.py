"""R4 — operand disagreement between paired segment transfers.

``_send_segment`` / ``_recv_segment`` / ``_recv_segment_into`` are the
two ends of one wire exchange: the sender frames (or raw-sends) with
its operand's dtype, the receiver sizes and decodes with its own. The
raw/framed decision and the element size are both pure functions of the
operand, so every segment call inside one collective must pass the SAME
operand expression — a mismatch means the two sides of the exchange
disagree about the bytes on the wire (silent corruption on the raw
path, shape/dtype errors on the framed one).

The rule checks each function independently: all segment-transfer call
sites in it must name one operand expression.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity
from ytk_mp4j_tpu_torch.analysis.rules.common import walk_pruned

# call name -> positional index of the operand argument
_SEGMENT_CALLS = {
    "_send_segment": 2,
    "_recv_segment": 2,
    "_recv_segment_into": 4,
}


def _operand_expr(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "operand":
            return kw.value
    idx = _SEGMENT_CALLS[call_name(call)]
    if len(call.args) > idx:
        return call.args[idx]
    return None


class R4OperandPairing(Rule):
    rule_id = "R4"
    severity = Severity.ERROR
    title = "segment operand mismatch"
    description = ("paired _send_segment/_recv_segment call sites in one "
                   "collective pass different operands")
    example = """\
class C:
    def bcast(self, arr, operand):
        if self.rank == 0:
            self._send_segment(1, arr, operand)
        else:
            self._recv_segment_into(0, arr, 0, 8, Operands.DOUBLE)
"""

    def visit_FunctionDef(self, node):           # noqa: N802
        # own body only; nested defs are visited as their own functions
        seen: dict[str, ast.Call] = {}           # operand dump -> first call
        for n in walk_pruned(node.body):
            if isinstance(n, ast.Call) and call_name(n) in _SEGMENT_CALLS:
                operand = _operand_expr(n)
                if operand is None:
                    continue
                key = ast.dump(operand)
                if seen and key not in seen:
                    first_key, first = next(iter(seen.items()))
                    self.report(n, (
                        f"segment transfer passes operand "
                        f"{ast.unparse(operand)!r} but a paired call at "
                        f"line {first.lineno} uses "
                        f"{ast.unparse(_operand_expr(first))!r} — sender "
                        f"and receiver will disagree on the wire format"))
                seen.setdefault(key, n)
        self.generic_visit_scoped(node)

    visit_AsyncFunctionDef = visit_FunctionDef
