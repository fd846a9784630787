"""R9 — pickled dict payload on a collective map path.

The columnar data plane ships numeric-operand map collectives as
(codes:int32, values) column pairs through the persistent key codec
(``comm.keycodec``): one vectorized encode per call, framed-array wire
frames, sorted-union merges. A pickled whole-dict send on a map path
re-introduces the per-call Kryo-analogue cost the codec exists to
amortize — and, worse, a rank that pickles while its exchange partner
expects column frames corrupts the wire protocol (the map-plane
equivalent of R4's operand mismatch). The ONE sanctioned pickle site is
the negotiated fallback helper (``_send_map_obj``: object values,
object operators, un-codec-able key mixes), accepted in baseline.toml.

Heuristic: inside a function in ``comm/`` whose name contains ``map``,
a ``_send`` / ``send_obj`` / ``_sendrecv`` call whose payload argument
is dict-shaped — a dict display, a ``dict(...)`` call, a name bound to
one in the same function, a conventional map identifier (``d``,
``acc``, ``m``, ``merged``, ``recv``, ``share``/``shares``, ``union``),
or a subscript of one (``shares[peer]``). Negotiation headers (tuples)
and column frames (``send_map_columns`` / ``send_array``) are not
flagged.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity

# callee -> index of the payload argument
_SEND_CALLS = {"_send": 1, "send_obj": 0, "_sendrecv": 2}

# the repo's conventional map-payload identifiers (R1-style vocabulary)
_MAP_NAMES = frozenset(
    {"d", "acc", "m", "merged", "recv", "share", "shares", "union"})


def _dict_bound_names(fn: ast.AST) -> set[str]:
    """Names assigned from a dict display or ``dict(...)`` call
    anywhere in ``fn`` (one level of data flow — enough for the
    ``acc = dict(d)`` shape the map tree uses)."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_dict_expr(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _is_dict_expr(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Dict) or isinstance(expr, ast.DictComp):
        return True
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Name)
            and expr.func.id == "dict")


def _is_dictish(expr: ast.AST, bound: set[str]) -> bool:
    if _is_dict_expr(expr):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in _MAP_NAMES or expr.id in bound
    if isinstance(expr, ast.Subscript):
        return _is_dictish(expr.value, bound)
    return False


class R9PickledMapPayload(Rule):
    rule_id = "R9"
    severity = Severity.ERROR
    title = "pickled map payload on a collective map path"
    description = ("a map collective sends a pickled dict instead of "
                   "routing through the columnar (codes, values) "
                   "encoder; outside the negotiated fallback this "
                   "re-pays the per-call serialization the key codec "
                   "amortizes and can desync the wire plane")
    example = """\
def reduce_map(self, d, operand, operator, root):
    acc = dict(d)
    self._send(0, acc, compress=operand.compress)   # pickled dict
"""

    def visit_FunctionDef(self, node):          # noqa: N802
        if self.ctx.in_dirs("comm") and "map" in node.name.lower():
            self.scope.append(node.name)
            try:
                self._scan(node)
            finally:
                self.scope.pop()
            return  # _scan covered the whole subtree (incl. nested defs)
        self.generic_visit_scoped(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # noqa: N815

    def _scan(self, fn: ast.AST) -> None:
        bound = _dict_bound_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            idx = _SEND_CALLS.get(call_name(node))
            if idx is None or len(node.args) <= idx:
                continue
            if _is_dictish(node.args[idx], bound):
                self.report(node, (
                    "pickled dict payload on a map collective path: "
                    "numeric-operand maps must travel as (codes, "
                    "values) columns through the key codec "
                    "(send_map_columns); only the negotiated fallback "
                    "site may pickle whole maps"))
