"""R17 — a metric family without a ``METRICS_DOC`` entry (doc drift).

The metrics plane's catalogue, :data:`ytk_mp4j_tpu_torch.obs.metrics.
METRICS_DOC`, is the one table operators (and the README's metric
table) trust to enumerate every series the job can emit. A family
registered in code but absent from the table is invisible
observability: it scrapes fine, graphs fine, and nobody knows it
exists or what it means — exactly the drift this rule guards against.

Two surfaces are checked:

- **registry registrations** anywhere in the package: a string-literal
  family name passed to ``<metrics>.inc(...)`` / ``set_gauge(...)`` /
  ``observe(...)`` (receiver heuristic: the terminal receiver name
  contains ``metric`` or is the conventional ``m``). An f-string
  family (``f"latency/{name}"``) is matched by its constant prefix
  against the table's ``<segment>`` wildcard keys.
- **Prometheus families** rendered in ``obs/metrics.py``: every
  ``# TYPE mp4j_*`` line (including f-string templates, matched by
  constant prefix) must name a documented family.

Fix: add the family's one-line entry to ``METRICS_DOC`` — or delete
the series.
"""

from __future__ import annotations

import ast
import re

from ytk_mp4j_tpu_torch.analysis.engine import Rule, call_name, receiver_chain
from ytk_mp4j_tpu_torch.analysis.report import Severity

_REGISTRY_METHODS = frozenset({"inc", "set_gauge", "observe"})
_TYPE_RE = re.compile(r"#\s*TYPE\s+(mp4j_[a-z0-9_]*)")


def _doc_keys() -> tuple:
    # resolved lazily so snippet tests exercise the REAL catalogue —
    # the rule's whole point is agreement with the shipped table
    from ytk_mp4j_tpu_torch.obs.metrics import METRICS_DOC
    return tuple(METRICS_DOC)


def documented(name: str, keys=None, prefix: bool = False) -> bool:
    """Whether ``name`` matches the catalogue: exactly, via a
    ``<segment>`` wildcard key's constant prefix, or — for an
    f-string's leading constant (``prefix=True``) — as a prefix of
    any key."""
    keys = _doc_keys() if keys is None else keys
    if name in keys:
        return True
    for k in keys:
        if "<" in k and name.startswith(k.split("<", 1)[0]):
            return True
        if prefix and name and k.startswith(name):
            return True
    return False


class R17MetricDoc(Rule):
    rule_id = "R17"
    severity = Severity.ERROR
    title = "metric family missing from METRICS_DOC"
    description = ("a metric family is registered or rendered without "
                   "a matching obs.metrics.METRICS_DOC entry — an "
                   "undocumented series is invisible observability")
    example = """\
def book(self):
    self._metrics.inc("nope/undocumented_family", 1)
"""

    def visit_Call(self, node: ast.Call):         # noqa: N802
        name = call_name(node)
        if name in _REGISTRY_METHODS and node.args:
            recv = receiver_chain(node)
            term = recv[-1] if recv else ""
            if "metric" in term or term == "m":
                self._check_family_arg(node, node.args[0])
        self.generic_visit(node)

    def _check_family_arg(self, call: ast.Call, arg: ast.AST) -> None:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if not documented(arg.value):
                self.report(call, (
                    f"metric family {arg.value!r} has no METRICS_DOC "
                    "entry — document it in obs/metrics.py (or use a "
                    "<segment> wildcard key) so the series is not "
                    "invisible observability"))
        elif isinstance(arg, ast.JoinedStr) and arg.values:
            head = arg.values[0]
            lead = (head.value if isinstance(head, ast.Constant)
                    and isinstance(head.value, str) else "")
            if not documented(lead, prefix=True):
                self.report(call, (
                    f"dynamic metric family with prefix {lead!r} "
                    "matches no METRICS_DOC key — add a "
                    "'<segment>'-style wildcard entry"))

    def visit_Constant(self, node: ast.Constant):  # noqa: N802
        # Prometheus `# TYPE` lines, only in the renderer module —
        # elsewhere a matching string is quoted documentation
        if self.ctx.path.endswith("obs/metrics.py") \
                and isinstance(node.value, str):
            for fam in _TYPE_RE.findall(node.value):
                # an f-string template's constant half ends mid-name
                # (`mp4j_rank_`): prefix-match those
                partial = node.value.rstrip().endswith(fam)
                if not documented(fam, prefix=partial):
                    self.report(node, (
                        f"Prometheus family {fam!r} is rendered but "
                        "has no METRICS_DOC entry — the endpoint "
                        "serves a series the catalogue denies exists"))
        self.generic_visit(node)
