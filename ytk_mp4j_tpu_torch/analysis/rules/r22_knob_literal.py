"""R22 — transport-decision size literal outside tuning/tuner.

The self-tuning data plane rests on ONE premise: every
numeric threshold that shapes a transport decision — routing floors,
ring minimums, chunk bounds, buffer sizes — lives in
``utils/tuning.py`` (static knobs + shared constants) or
``utils/tuner.py`` (policy parameters), where it is validated once,
documented once, and visible to the policy core. A size literal
inlined at a decision site in ``comm/`` or ``transport/`` is KNOB
DRIFT: the day someone tunes the central constant, the inlined twin
silently disagrees — and on a wire protocol (the shm ring/carrier
routing, the handshake's ring floor) a disagreement between two ranks
is a hang, not a slowdown. This is exactly the bug class once found
in the peer handshake (a hard-coded ``4096`` mirroring the
``MP4J_SHM_RING_BYTES`` validator's floor).

Heuristic: an integer literal >= ``_SIZE_FLOOR`` (4096 — below that
the literal is a small protocol constant, not a size knob) used as a
DECISION input in ``comm/`` or ``transport/``:

- an operand of a comparison (``n >= 262144`` — the routing shape);
- an argument of ``min()``/``max()`` (the clamp shape).

Plain data arguments (``recv(65536)``, ``listen(64)``) and
assignments are not flagged — only the sites where the literal
*decides*. Sanctioned sites carry inline suppressions or baseline
entries arguing why the literal is not a knob.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule
from ytk_mp4j_tpu_torch.analysis.report import Severity

_SIZE_FLOOR = 4096

_MSG = ("size literal {v} feeds a transport decision here: move it to "
        "utils/tuning.py (a validated knob / shared constant) or "
        "utils/tuner.py (a policy parameter) and reference it — an "
        "inlined size threshold drifts silently from the central knob "
        "it mirrors (on a wire-protocol decision, a drifted pair of "
        "ranks hangs)")


def _is_size_literal(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, int)
            and not isinstance(node.value, bool)
            and node.value >= _SIZE_FLOOR)


class R22KnobLiteral(Rule):
    rule_id = "R22"
    severity = Severity.ERROR
    title = "transport-decision size literal outside tuning/tuner"
    description = ("numeric size thresholds feeding transport "
                   "decisions in comm/ or transport/ must live in "
                   "utils/tuning.py or utils/tuner.py — an inlined "
                   "literal drifts from the knob it mirrors")
    example = """\
def send_raw(self, view):
    if len(view) >= 262144:     # inlined twin of SHM_RING_MIN_BYTES
        self._ring_send(view)
    else:
        self._carrier_send(view)
"""
    example_path = "ytk_mp4j_tpu_torch/transport/example.py"

    def _in_scope(self) -> bool:
        return self.ctx.in_dirs("comm", "transport")

    def visit_Compare(self, node):              # noqa: N802
        if self._in_scope():
            for cand in (node.left, *node.comparators):
                if _is_size_literal(cand):
                    self.report(cand, _MSG.format(v=cand.value))
        self.generic_visit(node)

    def visit_Call(self, node):                 # noqa: N802
        if (self._in_scope() and isinstance(node.func, ast.Name)
                and node.func.id in ("min", "max")):
            for cand in node.args:
                if _is_size_literal(cand):
                    self.report(cand, _MSG.format(v=cand.value))
        self.generic_visit(node)
